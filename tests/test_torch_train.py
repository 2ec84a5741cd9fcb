"""Port parity: ``train`` (losses, datasets, checkpoints, the optimizer and
the flagship update steps).

Float64 on the CPU. The losses equal the JAX package's to 1e-10 relative
(their gradients through the generator are held by the update steps);
the datasets give the same batches from the same numpy seed, exactly; the
clip equals optax's ``clip_by_global_norm`` to 1e-15 and ``ClippedAdam``
optax's ``chain(clip_by_global_norm, adam)`` over ten updates to 1e-12.
Three consecutive G, D and informed updates of the cGAN trainer, and three
decoder-pretrain updates, at ``hidden=(32,)`` on the 40-atom backbone, from
the same carried weights and JAX's own latent draws, give losses within
1e-9 relative and weights within 1e-9 of the largest weight. A random
generator's informed loss is about 1e12 kcal/mol, so the clip fires there.
Checkpoints round-trip a module, an optimizer's moments and an ``MDState``
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from molecular_dynamics_tpu import HarmonicSMDBias as JBias
from molecular_dynamics_tpu.models import cgan as jcgan_models
from molecular_dynamics_tpu.train import cgan as jcgan
from molecular_dynamics_tpu.train import checkpoint as jckpt
from molecular_dynamics_tpu.train import datasets as jdata
from molecular_dynamics_tpu.train import losses as jlosses
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.bias import HarmonicSMDBias as TBias
from molecular_dynamics_tpu_torch.features import knn_mask, phi_psi_indices
from molecular_dynamics_tpu_torch.models import Discriminator, Generator
from molecular_dynamics_tpu_torch.system import replicate, system_init
from molecular_dynamics_tpu_torch.train import cgan as tcgan
from molecular_dynamics_tpu_torch.train import checkpoint as tckpt
from molecular_dynamics_tpu_torch.train import datasets as tdata
from molecular_dynamics_tpu_torch.train import losses as tlosses
from molecular_dynamics_tpu_torch.train.common import ClippedAdam, clip_by_global_norm

from torch_parity import ff_to_numpy, t

RTOL = 1e-10
STEP_RTOL = 1e-9
B = 8
F64 = torch.float64


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def system(backbone_system):
    """The 40-atom backbone in both packages (float64), a batch of real
    frames, times, and the SMD bias of the cGAN driver in both."""
    top, jff, coords = backbone_system
    tff = tconvert.ff_params_from_numpy(ff_to_numpy(jff), device="cpu", dtype=F64)
    rng = np.random.default_rng(31)
    real = np.asarray(coords, np.float64)[None] + 0.2 * rng.standard_normal((B, 40, 3))
    times = rng.uniform(0.0, 1.0, B)
    kw = dict(n_atoms=40, group1=[0], group2=[39], fk=1.0, cent_0=13.0, cent_1=20.0, T=10000.0)
    return dict(top=top, jff=jff, tff=tff, real=real, times=times,
                jbias=JBias.create(dtype=jnp.float64, **kw), tbias=TBias.create(dtype=F64, device="cpu", **kw))


# -- losses ------------------------------------------------------------------


def test_energy_losses(system):
    real, jff, tff = system["real"], system["jff"], system["tff"]
    close(tlosses.potential_loss(t(real), tff), jax.jit(jlosses.potential_loss)(jnp.asarray(real), jff))
    weights = {"bonds": 0.5, "angles": 2.0, "lj": 1.5}
    close(tlosses.potential_loss(t(real), tff, term_weights=weights),
          jax.jit(lambda c: jlosses.potential_loss(c, jff, term_weights=weights))(jnp.asarray(real)))
    steps = system["times"] * 10000.0
    close(tlosses.bias_energy_loss(t(real), system["tbias"], t(steps)),
          jax.jit(lambda c, s: jlosses.bias_energy_loss(c, system["jbias"], s))(
              jnp.asarray(real), jnp.asarray(steps)))


def test_geometric_losses(system):
    real = system["real"]
    pred = real + 0.3 * np.random.default_rng(32).standard_normal(real.shape)
    jp, jr = jnp.asarray(pred), jnp.asarray(real)
    mask = knn_mask(40, 3)
    close(tlosses.distance_matrix_loss(t(pred), t(real)), jlosses.distance_matrix_loss(jp, jr))
    close(tlosses.distance_matrix_loss(t(pred), t(real), mask),
          jlosses.distance_matrix_loss(jp, jr, jnp.asarray(mask.numpy())))
    close(tlosses.rmsd_loss(t(pred), t(real)), jax.jit(jlosses.rmsd_loss)(jp, jr))
    phi, psi = phi_psi_indices(system["top"])
    close(tlosses.window_composite_loss(t(pred), t(real), t(phi), t(psi), mask, 1.0, 0.5, 2.0, 3.0),
          jax.jit(lambda a, b: jlosses.window_composite_loss(
              a, b, jnp.asarray(phi), jnp.asarray(psi), jnp.asarray(mask.numpy()), 1.0, 0.5, 2.0, 3.0))(
              jp, jr))


# -- datasets ----------------------------------------------------------------


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    rng = np.random.default_rng(33)
    root = tmp_path_factory.mktemp("traj")
    trajs = [rng.standard_normal((n, 6, 3)).astype(np.float32) for n in (23, 17, 30)]
    for r, arr in enumerate(trajs):
        np.save(root / f"raw-traj_rep-{r}.npy", arr)
    return str(root / "raw-traj_rep-*.npy"), trajs


def test_trajectory_data(trajectories):
    pattern, trajs = trajectories
    for stride, limit in ((1, None), (3, 2)):
        td = tdata.TrajectoryData.from_npy_glob(pattern, stride=stride, limit=limit)
        jd = jdata.TrajectoryData.from_npy_glob(pattern, stride=stride, limit=limit)
        assert (td.n_frames, td.n_atoms) == (jd.n_frames, jd.n_atoms)
        for a, b in zip(td.stacked(), jd.stacked()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    stack = np.stack([tr[:17] for tr in trajs])
    assert np.array_equal(tdata.TrajectoryData.from_array(stack, 2).stacked()[0],
                          jdata.TrajectoryData.from_array(stack, 2).stacked()[0])
    with pytest.raises(FileNotFoundError):
        tdata.TrajectoryData.from_npy_glob(pattern + ".missing")


def test_same_batches_from_the_same_seed(trajectories):
    _, trajs = trajectories
    td, jd = tdata.TrajectoryData(trajs), jdata.TrajectoryData(trajs)
    cases = (
        (tdata.frame_time_batches, jdata.frame_time_batches, (td, 8), (jd, 8), {}),
        (tdata.frame_time_batches, jdata.frame_time_batches, (td, 8), (jd, 8), {"drop_last": False}),
        (tdata.window_batches, jdata.window_batches, (td, 5, 2, 4), (jd, 5, 2, 4), {}),
        (tdata.window_batches, jdata.window_batches, (td, 5, 2, 4), (jd, 5, 2, 4), {"flatten": False}),
    )
    for tfn, jfn, targs, jargs, kw in cases:
        tb = list(tfn(*targs, rng=np.random.default_rng(5), **kw))
        jb = list(jfn(*jargs, rng=np.random.default_rng(5), **kw))
        assert len(tb) == len(jb) > 0
        for a, b in zip(tb, jb):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
    for a, b in zip(tdata.phase_space_pairs(td, dt=0.5), jdata.phase_space_pairs(jd, dt=0.5)):
        assert np.array_equal(a, b)


def test_scaler_and_buckets(trajectories):
    frames = np.concatenate(trajectories[1])
    frames[:, 2, 1] = 4.0  # a degenerate channel
    ts, js = tdata.PerAtomMinMaxScaler(frames), jdata.PerAtomMinMaxScaler(frames)
    assert np.array_equal(ts.transform(frames), js.transform(frames))
    assert np.array_equal(ts.inverse(ts.transform(frames)), js.inverse(js.transform(frames)))
    for chunk in (1, 2, 5):
        assert tdata.bucket_bounds(chunk) == jdata.bucket_bounds(chunk)
    with pytest.raises(ValueError):
        tdata.bucket_bounds(0)
    with pytest.raises(ValueError):
        tdata.PerAtomMinMaxScaler(frames[0])


# -- optimizer ---------------------------------------------------------------


def _grads(rng, scale):
    return [scale * rng.standard_normal(shape) for shape in ((4, 3), (3,), (2, 2))]


def test_clip_is_optax_exact():
    rng = np.random.default_rng(34)
    for scale in (0.01, 0.3, 5.0, 1e6):
        grads = _grads(rng, scale)
        want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
        got = clip_by_global_norm([t(g) for g in grads], 1.0)
        for a, b in zip(got, want):
            close(a, b, 1e-15)
    # torch's own clip divides by norm + 1e-6: not the same update
    grads = [t(g) for g in _grads(rng, 1.0)]
    ours = clip_by_global_norm(grads, 0.5)
    theirs = [g.clone() for g in grads]
    torch.nn.utils.clip_grad_norm_(theirs, 0.5)
    assert max(float((a - b).abs().max()) for a, b in zip(ours, theirs)) > 1e-8


def test_clipped_adam_is_optax_chain():
    rng = np.random.default_rng(35)
    init = _grads(rng, 1.0)
    params = [t(p).requires_grad_(True) for p in init]
    opt = ClippedAdam(params, lr=1e-2, clip_norm=1.0)
    jparams = [jnp.asarray(p) for p in init]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2))
    state = tx.init(jparams)
    for k in range(10):
        grads = _grads(rng, 10.0 ** (k % 4 - 2))
        opt.step([t(g) for g in grads])
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for p, q in zip(params, jparams):
        assert p.grad is None
        close(p.detach(), q, 1e-12)


# -- the flagship update steps -----------------------------------------------


@pytest.fixture(scope="module")
def jax_trainer(system):
    gen = jcgan_models.Generator(n_atoms=40, hidden=(32,))
    disc = jcgan_models.Discriminator(hidden=(32,))
    init_fn, opts, g_step, d_step, i_step = jcgan.make_cgan_trainer(
        gen, disc, system["jff"], bias=system["jbias"])
    # flax keeps float32 weights under x64: take them to float64, so that
    # JAX's updates are float64 throughout too
    g_params, d_params = jax.tree.map(lambda x: x.astype(jnp.float64), init_fn(jax.random.PRNGKey(4)))
    popt, p_step = jcgan.make_pretrain_step(gen, system["jff"], lr=1e-3)
    return dict(gen=gen, opts=opts, steps=(g_step, d_step, i_step), g_params=g_params,
                d_params=d_params, popt=popt, p_step=p_step)


def _carried(jt, which):
    params = jax.tree.map(np.asarray, jt[f"{which}_params"])
    module = (Generator(40, hidden=(32,), dtype=F64, device="cpu") if which == "g"
              else Discriminator(120, hidden=(32,), dtype=F64, device="cpu"))
    module.load_state_dict(tconvert.flax_params_to_state_dict(params, F64))
    return module


def _same_weights(module, jparams):
    want = tconvert.flax_params_to_state_dict(jax.tree.map(np.asarray, jparams), F64)
    got = module.state_dict()
    scale = max(float(v.abs().max()) for v in want.values())
    for key, value in want.items():
        assert float((got[key] - value).abs().max()) <= STEP_RTOL * scale, key


def _latent(key):
    return np.asarray(jax.random.normal(key, (B, 31)))


def test_cgan_steps_match_jax(system, jax_trainer):
    jt = jax_trainer
    g_step, d_step, i_step = jt["steps"]
    og, od, oi = jt["opts"]
    gp, dp = jt["g_params"], jt["d_params"]
    g_opt, d_opt, i_opt = og.init(gp), od.init(dp), oi.init(gp)
    gen, disc = _carried(jt, "g"), _carried(jt, "d")
    trainer = tcgan.CGANTrainer(gen, disc, system["tff"], bias=system["tbias"])
    real, times = jnp.asarray(system["real"]), jnp.asarray(system["times"])
    key = jax.random.PRNGKey(9)
    informed = []
    for _ in range(3):
        key, k1, k2, k3 = jax.random.split(key, 4)
        gp, g_opt, jl = g_step(gp, g_opt, dp, k1, times)
        tl = trainer.g_step(t(_latent(k1)), t(times))
        close(tl, jl, STEP_RTOL)
        _same_weights(gen, gp)
        dp, d_opt, jl = d_step(dp, d_opt, gp, k2, real, times)
        tl = trainer.d_step(t(_latent(k2)), t(system["real"]), t(times))
        close(tl, jl, STEP_RTOL)
        _same_weights(disc, dp)
        gp, i_opt, jl = i_step(gp, i_opt, k3, times)
        tl = trainer.informed_step(t(_latent(k3)), t(times))
        close(tl, jl, STEP_RTOL)
        _same_weights(gen, gp)
        informed.append(float(tl))
    assert informed[0] > 1e6  # far above the clip: the clip fires


def test_pretrain_steps_match_jax(system, jax_trainer):
    jt = jax_trainer
    gp = jt["g_params"]
    opt_state = jt["popt"].init(gp)
    gen = _carried(jt, "g")
    step = tcgan.PretrainStep(gen, system["tff"], lr=1e-3)
    real, times = jnp.asarray(system["real"]), jnp.asarray(system["times"])
    key = jax.random.PRNGKey(12)
    for alpha in (0.0, 0.005, 0.01):
        key, sub = jax.random.split(key)
        gp, opt_state, jl, jparts = jt["p_step"](gp, opt_state, sub, real, times, alpha)
        tl, tparts = step(t(_latent(sub)), t(system["real"]), t(times), alpha)
        close(tl, jl, STEP_RTOL)
        for a, b in zip(tparts, jparts):
            close(a, b, STEP_RTOL)
        _same_weights(gen, gp)


def test_steps_touch_only_their_module(system):
    """G's adversarial pass runs through D: D's weights and ``.grad`` stay
    as they were; D's update leaves G alone."""
    gen = Generator(40, hidden=(32,), dtype=F64, device="cpu", generator=torch.Generator().manual_seed(1))
    disc = Discriminator(120, hidden=(32,), dtype=F64, device="cpu", generator=torch.Generator().manual_seed(2))
    trainer = tcgan.CGANTrainer(gen, disc, system["tff"])
    z, times = torch.randn(B, 31, dtype=F64), t(system["times"])
    d_before = {k: v.clone() for k, v in disc.state_dict().items()}
    trainer.g_step(z, times)
    assert all(torch.equal(disc.state_dict()[k], v) for k, v in d_before.items())
    assert all(p.grad is None for p in (*gen.parameters(), *disc.parameters()))
    g_before = {k: v.clone() for k, v in gen.state_dict().items()}
    trainer.d_step(z, t(system["real"]), times)
    assert all(torch.equal(gen.state_dict()[k], v) for k, v in g_before.items())
    assert trainer.opt_g.adam is not trainer.opt_i.adam


# -- checkpoints -------------------------------------------------------------


def test_checkpoint_round_trips(tmp_path):
    gen = Generator(10, hidden=(16,), device="cpu", generator=torch.Generator().manual_seed(0))
    opt = ClippedAdam(gen.parameters(), lr=1e-3)
    opt.step([torch.randn_like(p) for p in gen.parameters()])
    state = replicate(system_init(torch.randn(10, 3), vel=torch.randn(10, 3), key=7, device="cpu"), 3, seed=2)
    state = state.replace(step=state.step + 5)
    target = {"gen": gen, "opt": opt, "md": state, "epoch": 4}
    path = str(tmp_path / "ckpt" / "all.pt")
    tckpt.save(path, target)

    fresh = Generator(10, hidden=(16,), device="cpu", generator=torch.Generator().manual_seed(1))
    fresh_opt = ClippedAdam(fresh.parameters(), lr=1e-3)
    template = {"gen": fresh, "opt": fresh_opt,
                "md": replicate(system_init(torch.zeros(10, 3), device="cpu"), 3), "epoch": 0}
    restored, resumed = tckpt.resume_or_init(path, template)
    assert resumed and restored["epoch"] == 4 and restored["gen"] is fresh
    for k, v in gen.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
    for field in ("pos", "vel", "forces", "box", "key", "step"):
        a, b = getattr(restored["md"], field), getattr(state, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field
    moments = [s for s in fresh_opt.state_dict()["state"].values()]
    want = [s for s in opt.state_dict()["state"].values()]
    for a, b in zip(moments, want):
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    # the next update from the restored optimizer equals the original's
    g = [torch.randn_like(p) for p in gen.parameters()]
    opt.step(g)
    fresh_opt.step(g)
    assert all(torch.equal(a, b) for a, b in zip(gen.parameters(), fresh.parameters()))
    missing, resumed = tckpt.resume_or_init(str(tmp_path / "none.pt"), template)
    assert missing is template and not resumed


def test_keepers_follow_the_reference(tmp_path):
    losses = [3.0, 2.5, 2.7, float("inf"), 1.0, 1.0]
    tk, jk = tckpt.BestKeeper(str(tmp_path / "t.pt")), jckpt.BestKeeper(str(tmp_path / "j.ckpt"))
    gen = Generator(4, hidden=(8,), device="cpu")
    for loss in losses:
        assert tk.update(loss, gen) == jk.update(loss, {"w": np.zeros(2)})
    assert tk.best == jk.best == 1.0
    tk.rebase()
    assert tk.best == float("inf") and tk.update(5.0, gen)
    saver = tckpt.PeriodicSaver(str(tmp_path / "latest.pt"), every=3)
    assert [saver.maybe_save(s, gen) for s in range(1, 7)] == [False, False, True, False, False, True]
    restored = tckpt.load(str(tmp_path / "latest.pt"), Generator(4, hidden=(8,), device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(restored.parameters(), gen.parameters()))
