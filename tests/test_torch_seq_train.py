"""Port parity: the sequence trainers and rollouts against JAX's, float64.

Every trainer of ``train/seq.py`` (window, NLL, Seq2Seq, adversarial
Seq2Seq, graph Seq2Seq) and the transformer's next-frame MSE step (the JAX
driver's inline step) takes two steps from JAX's weights on the same
batches, its decoder fed JAX's draws (one key a batch; the graph trainer
one key a row): the losses, the first step's gradients and the parameters
after each step agree to 1e-9. The window trainer's LSTM keeps one bias a
gate, so its clipped-Adam steps equal optax's (two trainable biases would
move twice as fast). The four rollouts equal JAX's, one start at a time,
with the same draws: the autoregressive one through the FIRE corrector,
the graph one through the driver's torsion refeaturizer, itself equal to
the JAX driver's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from molecular_dynamics_tpu.features import knn_mask as j_knn_mask
from molecular_dynamics_tpu.features import per_atom_angle_rows as j_angle_rows
from molecular_dynamics_tpu.features import phi_psi as j_phi_psi
from molecular_dynamics_tpu.models import gat as jgat
from molecular_dynamics_tpu.models import seq as jseq
from molecular_dynamics_tpu.models import transformer as jtransformer
from molecular_dynamics_tpu.train import losses as jlosses
from molecular_dynamics_tpu.train import seq as jtrain
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.features import knn_mask, per_atom_angle_rows
from molecular_dynamics_tpu_torch.models import gat as tgat
from molecular_dynamics_tpu_torch.models import seq as tseq
from molecular_dynamics_tpu_torch.models import transformer as ttransformer
from molecular_dynamics_tpu_torch.train import drivers as tdrivers
from molecular_dynamics_tpu_torch.train import seq as ttrain

from torch_parity import ff_to_numpy, float64_lstm_carries, t

F64 = torch.float64
TOL = 1e-9
KEY = jax.random.PRNGKey(5)
N_ATOMS = 8  # the window trainer's frames: 8 atoms, 24 features
PHI = np.array([[0, 1, 2, 3], [3, 4, 5, 6]])
PSI = np.array([[1, 2, 3, 4], [4, 5, 6, 7]])


@pytest.fixture(autouse=True)
def _carries(monkeypatch):
    float64_lstm_carries(monkeypatch)


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32).astype(np.float64)


def init64(jmodel, *args):
    static = tuple(i + 1 for i, a in enumerate(args) if isinstance(a, int))
    params = jax.jit(jmodel.init, static_argnums=static)(KEY, *args)
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)


def load(module, params):
    module.load_state_dict(tconvert.flax_params_to_state_dict(
        jax.tree.map(np.asarray, params), F64))
    return module


def cpu64(cls, *args, **kw):
    return cls(*args, device="cpu", dtype=F64, **kw)


def assert_state(module, params):
    want = tconvert.flax_params_to_state_dict(jax.tree.map(np.asarray, params), F64)
    for name, value in module.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


def assert_grads(module, loss, jgrads):
    grads = torch.autograd.grad(loss, list(module.parameters()))
    want = tconvert.flax_params_to_state_dict(jax.tree.map(np.asarray, jgrads), F64)
    for (name, _), g in zip(module.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


def two_steps(module, params, jstep, tstep, tloss, jloss, batches):
    """Gradients before the first update, then each step's loss and the
    parameters after it."""
    assert_grads(module, tloss(*batches[0][1]), jax.jit(jax.grad(jloss))(params, *batches[0][0]))
    opt_state = None
    for jbatch, tbatch in batches:
        params, opt_state, want = jstep(params, opt_state, *jbatch)
        np.testing.assert_allclose(float(tstep(*tbatch)), float(want), rtol=TOL)
        assert_state(module, params)


# -- the trainers -------------------------------------------------------------------


def test_single_bias_lstm_window_steps_match_optax():
    """The composite window loss through an LSTM: one trainable bias a gate
    (three parameters a layer), the clip firing at 0.05."""
    rng = np.random.default_rng(0)
    jmodel = jseq.LSTMPredictor(out_dim=3 * N_ATOMS, hidden_size=16)
    params = init64(jmodel, jnp.zeros((1, 4, 3 * N_ATOMS)))
    module = load(cpu64(tseq.LSTMPredictor, 3 * N_ATOMS, 3 * N_ATOMS, 16), params)
    assert len(list(module.parameters())) == 3 + 2
    cfg = jtrain.SeqTrainConfig(n_atoms=N_ATOMS, knn_k=2, clip_norm=0.05, lr=1e-2)
    opt, step = jtrain.make_window_trainer(jmodel, PHI, PSI, cfg)
    tcfg = ttrain.SeqTrainConfig(n_atoms=N_ATOMS, knn_k=2, clip_norm=0.05, lr=1e-2)
    _, tstep = ttrain.make_window_trainer(module, PHI, PSI, tcfg)
    knn = j_knn_mask(N_ATOMS, 2)

    def jloss(p, w, y):
        pred = jmodel.apply(p, w).reshape(-1, N_ATOMS, 3)
        return jlosses.window_composite_loss(pred, y.reshape(-1, N_ATOMS, 3), PHI, PSI, knn)

    def jstep(p, state, w, y):
        return step(p, opt.init(p) if state is None else state, w, y)

    batches = [((w, y), (t(w), t(y))) for w, y in
               ((f32(rng, 3, 4, 24), f32(rng, 3, 24)) for _ in range(2))]
    tloss = lambda w, y: ttrain.window_loss(  # noqa: E731
        module, w, y, torch.as_tensor(PHI), torch.as_tensor(PSI),
        knn_mask(N_ATOMS, 2), tcfg)
    two_steps(module, params, jstep, tstep, tloss, jloss, batches)


def test_nll_and_mse_trainers_match_jax():
    rng = np.random.default_rng(1)
    jmodel = jseq.LSTMNLLPredictor(out_dim=6, hidden_size=12)
    params = init64(jmodel, jnp.zeros((1, 4, 6)))
    module = load(cpu64(tseq.LSTMNLLPredictor, 6, 6, 12), params)
    opt, step = jtrain.make_nll_trainer(jmodel)
    _, tstep = ttrain.make_nll_trainer(module)
    batches = [((w, y), (t(w), t(y))) for w, y in
               ((f32(rng, 3, 4, 6), f32(rng, 3, 6)) for _ in range(2))]
    two_steps(module, params, lambda p, s, w, y: step(p, opt.init(p) if s is None else s, w, y),
              tstep, lambda w, y: ttrain.nll_loss(module, w, y),
              lambda p, w, y: jseq.gaussian_nll(*jmodel.apply(p, w), y), batches)

    # the transformer's step: the JAX driver's inline next-frame MSE
    jtr = jtransformer.TrajectoryTransformer(out_dim=6, d_model=8, n_heads=2, n_layers=2, d_ff=16)
    params = init64(jtr, jnp.zeros((1, 5, 6)))
    module = load(cpu64(ttransformer.TrajectoryTransformer, 6, 6, 8, 2, 2, 16, history=5), params)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))
    jloss = lambda p, w, y: jnp.mean((jtr.apply(p, w) - y) ** 2)  # noqa: E731

    @jax.jit
    def jstep(p, s, w, y):
        val, grads = jax.value_and_grad(jloss)(p, w, y)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, val

    _, tstep = ttrain.make_mse_trainer(module)
    batches = [((w, y), (t(w), t(y))) for w, y in
               ((rng.standard_normal((3, 5, 6)), rng.standard_normal((3, 6))) for _ in range(2))]
    two_steps(module, params, lambda p, s, w, y: jstep(p, opt.init(p) if s is None else s, w, y),
              tstep, lambda w, y: ttrain.mse_loss(module, w, y), jloss, batches)


def seq2seq_noise(key, shape):
    return t(jax.random.normal(key, shape, jnp.float32), F64)


def test_seq2seq_trainer_matches_jax():
    rng = np.random.default_rng(2)
    jmodel = jseq.Seq2Seq(out_dim=6, hidden_size=12, noise_dim=4)
    params = init64(jmodel, jnp.zeros((1, 3, 6)), KEY, 2)
    module = load(cpu64(tseq.Seq2Seq, 6, 6, 12, 4), params)
    opt, step = jtrain.make_seq2seq_trainer(jmodel, 2)
    _, tstep = ttrain.make_seq2seq_trainer(module)
    batches = []
    for j in range(2):
        key, w, y = jax.random.PRNGKey(20 + j), f32(rng, 3, 3, 6), f32(rng, 3, 2, 6)
        batches.append(((key, w, y), (seq2seq_noise(key, (3, 2, 4)), t(w), t(y))))
    two_steps(module, params, lambda p, s, k, w, y: step(p, opt.init(p) if s is None else s, k, w, y),
              tstep, lambda z, w, y: ttrain.seq2seq_loss(module, z, w, y),
              lambda p, k, w, y: jnp.mean((jmodel.apply(p, w, k, 2) - y) ** 2), batches)


def test_seq2seq_gan_steps_match_jax():
    """g then d on each batch (d reads the updated generator), the g step
    through the critic's current weights: the two modules after each."""
    rng = np.random.default_rng(3)
    gen, disc = jseq.Seq2Seq(out_dim=6, hidden_size=12, noise_dim=4), \
        jseq.SequenceDiscriminator(hidden_size=10)
    gp, dp = init64(gen, jnp.zeros((1, 3, 6)), KEY, 2), init64(disc, jnp.zeros((1, 2, 6)))
    tgen = load(cpu64(tseq.Seq2Seq, 6, 6, 12, 4), gp)
    tdisc = load(cpu64(tseq.SequenceDiscriminator, 6, 10), dp)
    opt_g, opt_d, g_step, d_step = jtrain.make_seq2seq_gan_trainer(gen, disc, 2)
    _, _, tg_step, td_step = ttrain.make_seq2seq_gan_trainer(tgen, tdisc)
    g_opt, d_opt = opt_g.init(gp), opt_d.init(dp)
    for j in range(2):
        k1, k2 = jax.random.split(jax.random.PRNGKey(30 + j))
        w, y = f32(rng, 3, 3, 6), f32(rng, 3, 2, 6)
        z1, z2 = seq2seq_noise(k1, (3, 2, 4)), seq2seq_noise(k2, (3, 2, 4))
        if j == 0:
            def jg(p):
                pred = gen.apply(p, w, k1, 2)
                logits = disc.apply(dp, pred)
                return jnp.mean((pred - y) ** 2) + 0.1 * jnp.mean(
                    optax.sigmoid_binary_cross_entropy(logits, jnp.ones_like(logits)))
            assert_grads(tgen, ttrain.gan_generator_loss(tgen, tdisc, z1, t(w), t(y)),
                         jax.jit(jax.grad(jg))(gp))
        gp, g_opt, g_loss = g_step(gp, g_opt, dp, k1, w, y)
        np.testing.assert_allclose(float(tg_step(z1, t(w), t(y))), float(g_loss), rtol=TOL)
        assert_state(tgen, gp)
        if j == 0:
            fake = jax.jit(gen.apply, static_argnums=3)(gp, w, k2, 2)

            def jd(p):
                lr, lf = disc.apply(p, y), disc.apply(p, fake)
                return jnp.mean(optax.sigmoid_binary_cross_entropy(lr, jnp.ones_like(lr))) + \
                    jnp.mean(optax.sigmoid_binary_cross_entropy(lf, jnp.zeros_like(lf)))
            assert_grads(tdisc, ttrain.gan_critic_loss(tdisc, tgen, z2, t(w), t(y)),
                         jax.jit(jax.grad(jd))(dp))
        dp, d_opt, d_loss = d_step(dp, d_opt, gp, k2, w, y)
        np.testing.assert_allclose(float(td_step(z2, t(w), t(y))), float(d_loss), rtol=TOL)
        assert_state(tdisc, dp)


def graph_noise(key, rows, shape):
    """The graph trainer's draws: one key a row, split from the batch's."""
    return t(np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                       for k in jax.random.split(key, rows)]), F64)


def test_graph_seq2seq_trainer_matches_jax():
    rng = np.random.default_rng(4)
    jmodel = jgat.GraphSeq2Seq(hidden_size=8, k=2)
    params = init64(jmodel, jnp.zeros((6, 3, 5)), KEY, 2)
    module = load(cpu64(tgat.GraphSeq2Seq, 5, 8, 2), params)
    opt, step = jtrain.make_graph_seq2seq_trainer(jmodel, 2)
    _, tstep = ttrain.make_graph_seq2seq_trainer(module)

    def jloss(p, key, w, y):  # the trainer's loss, as make_graph_seq2seq_trainer writes it
        keys = jax.random.split(key, w.shape[0])
        pred = jax.vmap(lambda a, k: jmodel.apply(p, a, k, 2))(w, keys)
        pos_p, pos_t = jnp.swapaxes(pred[..., :3], 1, 2), jnp.swapaxes(y[..., :3], 1, 2)
        e2e = lambda q: jnp.linalg.norm(q[..., :3, :] - jnp.flip(q, -2)[..., :3, :], axis=-1)  # noqa: E731
        return (jnp.mean((pos_p - pos_t) ** 2) + 0.1 * jnp.mean((pred[..., 3:] - y[..., 3:]) ** 2)
                + jnp.mean((e2e(pos_p) - e2e(pos_t)) ** 2))

    batches = []
    for j in range(2):
        key, w, y = jax.random.PRNGKey(40 + j), f32(rng, 2, 6, 3, 5), f32(rng, 2, 6, 2, 5)
        batches.append(((key, w, y), (graph_noise(key, 2, (2, 6, 5)), t(w), t(y))))
    two_steps(module, params, lambda p, s, k, w, y: step(p, opt.init(p) if s is None else s, k, w, y),
              tstep, lambda z, w, y: ttrain.graph_seq2seq_loss(module, z, w, y),
              jax.jit(jloss), batches)


# -- the rollouts -------------------------------------------------------------------


def split_chain(key, n):
    """The subkeys a JAX rollout splits off its key, one a step."""
    subs = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def test_autoregressive_rollout_with_the_fire_corrector(backbone_system):
    """Two starts as rows of one batched rollout, each frame relaxed by 3
    FIRE steps on the 40-atom backbone (whitened features)."""
    top, jff, coords = backbone_system
    tff = tconvert.ff_params_from_numpy(ff_to_numpy(jff), device="cpu", dtype=F64)
    rng = np.random.default_rng(5)
    jmodel = jseq.LSTMPredictor(out_dim=120, hidden_size=8)
    params = init64(jmodel, jnp.zeros((1, 3, 120)))
    module = load(cpu64(tseq.LSTMPredictor, 120, 120, 8), params)
    mean = np.asarray(coords, np.float64).reshape(-1)
    std = np.full(120, 0.5)
    windows = f32(rng, 2, 3, 120)
    jcorr = jtrain.make_frame_corrector(jff, mean, std, n_steps=3)
    roll = jax.jit(lambda p, w: jtrain.autoregressive_rollout(jmodel, p, w, 4, corrector=jcorr))
    got = ttrain.autoregressive_rollout(
        module, t(windows), 4, corrector=ttrain.make_frame_corrector(tff, mean, std, n_steps=3))
    assert got.shape == (4, 2, 120)
    for r in range(2):
        np.testing.assert_allclose(got[:, r].numpy(), np.asarray(roll(params, windows[r])),
                                   rtol=TOL, atol=TOL)


def test_nll_and_chained_rollouts_match_jax():
    """Sampled and chained-decode rollouts of two starts, each fed the
    draws JAX's rollout splits from that start's key."""
    rng = np.random.default_rng(6)
    keys = jax.random.split(jax.random.PRNGKey(50), 2)
    jnll = jseq.LSTMNLLPredictor(out_dim=6, hidden_size=10)
    params = init64(jnll, jnp.zeros((1, 4, 6)))
    module = load(cpu64(tseq.LSTMNLLPredictor, 6, 6, 10), params)
    windows = f32(rng, 2, 4, 6)
    noise = np.stack([[np.asarray(jax.random.normal(s, (6,), jnp.float64))
                       for s in split_chain(k, 5)] for k in keys], axis=1)
    got = ttrain.nll_sampling_rollout(module, t(windows), 5, noise=t(noise))
    roll = jax.jit(lambda p, w, k: jtrain.nll_sampling_rollout(jnll, p, w, k, 5))
    for r in range(2):
        np.testing.assert_allclose(got[:, r].numpy(), np.asarray(roll(params, windows[r], keys[r])),
                                   rtol=TOL, atol=TOL)

    js2s = jseq.Seq2Seq(out_dim=6, hidden_size=10, noise_dim=3)
    params = init64(js2s, jnp.zeros((1, 4, 6)), KEY, 2)
    module = load(cpu64(tseq.Seq2Seq, 6, 6, 10, 3), params)
    # 7 steps: three segments of 2, the last step dropped as in JAX
    noise = np.stack([[np.asarray(jax.random.normal(s, (2, 3), jnp.float32))
                       for s in split_chain(k, 3)] for k in keys], axis=1)
    got = ttrain.chained_decode_rollout(module, t(windows), 2, 7, noise=t(noise, F64))
    assert got.shape == (6, 2, 6)
    roll = jax.jit(lambda p, w, k: jtrain.chained_decode_rollout(js2s, p, w, k, 2, 7))
    for r in range(2):
        np.testing.assert_allclose(got[:, r].numpy(), np.asarray(roll(params, windows[r], keys[r])),
                                   rtol=TOL, atol=TOL)
    assert ttrain.chained_decode_rollout(module, t(windows), 2, 7,
                                         generator=torch.Generator()).shape == (6, 2, 6)


def jax_refeature(top, w_mean, w_std):
    """The JAX driver's rollout refeaturizer (``_run_seq2seq_graph``), as
    it is written there."""
    phi_idx, psi_idx, phi_row, psi_row = j_angle_rows(top)
    mean_j, std_j = jnp.asarray(w_mean, jnp.float32), jnp.asarray(w_std, jnp.float32)

    def refeature(seg):  # (N, L, 5)
        xyz_w = jnp.swapaxes(seg[..., :3], 0, 1)
        pos = (xyz_w.reshape(xyz_w.shape[0], -1) * std_j + mean_j).reshape(xyz_w.shape)
        ph, ps = jax.vmap(lambda p: j_phi_psi(p, phi_idx, psi_idx))(pos)
        a_phi = jnp.where(phi_row >= 0, ph[:, jnp.clip(phi_row, 0, None)], 0.0)
        a_psi = jnp.where(psi_row >= 0, ps[:, jnp.clip(psi_row, 0, None)], 0.0)
        return jnp.concatenate([seg[..., :3], jnp.swapaxes(a_phi, 0, 1)[..., None],
                                jnp.swapaxes(a_psi, 0, 1)[..., None]], axis=-1)

    return refeature


def test_graph_chained_rollout_with_refeature_matches_jax(backbone_system):
    """The 40-atom backbone's per-atom [xyz, phi, psi] windows, the torsion
    channels rebuilt from each decoded segment by the port driver's
    refeaturizer (equal to JAX's on its own)."""
    top = backbone_system[0]
    rows = per_atom_angle_rows(top)
    for a, b in zip(rows, j_angle_rows(top)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(7)
    mean, std = np.asarray(backbone_system[2]).reshape(-1), np.full(120, 0.7)
    jref = jax_refeature(top, mean, std)
    tref = tdrivers._refeaturizer(*rows, mean, std, "cpu")
    seg = rng.standard_normal((40, 3, 5))
    np.testing.assert_allclose(tref(t(seg)).numpy(), np.asarray(jax.jit(jref)(seg)),
                               rtol=TOL, atol=TOL)
    jmodel = jgat.GraphSeq2Seq(hidden_size=8, k=6)
    params = init64(jmodel, jnp.zeros((40, 4, 5)), KEY, 2)
    module = load(cpu64(tgat.GraphSeq2Seq, 5, 8, 6), params)
    windows = f32(rng, 2, 40, 4, 5)
    keys = jax.random.split(jax.random.PRNGKey(60), 2)
    noise = np.stack([[np.asarray(jax.random.normal(s, (2, 40, 5), jnp.float32))
                       for s in split_chain(k, 2)] for k in keys], axis=1)
    got = ttrain.graph_chained_decode_rollout(module, t(windows), 2, 5, noise=t(noise, F64),
                                              refeature=tref)
    assert got.shape == (4, 2, 40, 5)
    roll = jax.jit(lambda p, w, k: jtrain.graph_chained_decode_rollout(
        jmodel, p, w, k, 2, 5, refeature=jref))
    for r in range(2):
        np.testing.assert_allclose(got[:, r].numpy(), np.asarray(roll(params, windows[r], keys[r])),
                                   rtol=TOL, atol=TOL)
