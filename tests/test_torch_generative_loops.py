"""Port parity: the generative line's training loops against the JAX
drivers', from JAX's initial weights and draws; and each driver end to end.

The four loops: ``flow`` (NLL batches), ``vae`` (one reparameterisation key
a batch), ``aae`` (two optimizers, a prior draw a batch, the evaluator probe
on fixed prior draws) and ``sde`` (per batch one generator and three
gradient-penalised critic updates, a potential-injection update every
tenth, weight averaging from half the run). Float32 in both packages, on 2
trajectories of the in-repo backbone data at every tenth frame (32 frames
each, smooth enough that the SDE's CDE critic stays finite), seed 0: the
same numpy batches, phases and logging cadence give the same logged losses
within 1e-3 relative (the SDE-GAN narrowed and slowed through its knobs,
its probe off; the AAE's probe every epoch). The port's modules
start from the weights JAX's driver initialises (the SDE-GAN's JAX driver
from the port's seeded ones, carried the other way), and its draws
(``drivers._noise``, ``_uniform``, ``_fixed_latents``) replay the keys the
JAX driver splits, in its order.
"""

import csv
import json
import pathlib
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molecular_dynamics_tpu.log as jlog
from molecular_dynamics_tpu.models import autoencoder as jae
from molecular_dynamics_tpu.models import flows as jflows
from molecular_dynamics_tpu.models import sde as jsde
from molecular_dynamics_tpu.models import vae as jvae
from molecular_dynamics_tpu.train import drivers as jdrivers
from molecular_dynamics_tpu.train import sde as jtrain_sde
from molecular_dynamics_tpu_torch import cli as tcli
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch import log as tlog
from molecular_dynamics_tpu_torch.models import autoencoder as tae
from molecular_dynamics_tpu_torch.models import flows as tflows
from molecular_dynamics_tpu_torch.models import sde as tsde
from molecular_dynamics_tpu_torch.models import vae as tvae
from molecular_dynamics_tpu_torch.train import drivers as tdrivers

import torch_parity  # noqa: F401  (one torch thread a test worker)

DATA_STRIDE = 10


DATA = pathlib.Path(__file__).resolve().parents[1] / "datasets" / "backbone_smd"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    for r in range(2):
        shutil.copy(DATA / f"raw-traj_rep-{r}.npy", root / f"raw-traj_rep-{r}.npy")
    return str(root / "*.npy")


def _log_rows(path):
    with open(path) as fh:
        return [(int(r["epoch"]), int(r["step"]), float(r["loss"])) for r in csv.DictReader(fh)]


def _record(inits, name, params):
    inits[name] = tconvert.flax_params_to_state_dict(jax.tree.map(np.asarray, params),
                                                     torch.float32)


def _recording(init, inits, name):
    """``init``, jitted (the same weights; op by op it takes seconds),
    recording what it returns under ``name``."""
    def recorded(self, *args):
        static = tuple(i for i, a in enumerate(args) if isinstance(a, int))
        params = jax.jit(lambda *a: init(self, *a), static_argnums=static)(*args)
        _record(inits, name, params)
        return params
    return recorded


def _carry(monkeypatch, module, name, state):
    """Build the port's ``module.name`` with JAX's initial weights."""
    cls = getattr(module, name)

    def built(*args, **kw):
        obj = cls(*args, **kw)
        obj.load_state_dict(state)
        return obj

    monkeypatch.setattr(module, name, built)


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _sde_trainer(inits):
    """JAX's ``make_sde_gan_trainer`` whose ``init_fn`` hands out the
    port's seeded initial weights (at the test's widths), carried across by
    ``convert.state_dict_to_flax_params`` and recorded for the port's run:
    both drivers start from the same weights without tracing flax's init."""
    make = jtrain_sde.make_sde_gan_trainer
    cpu_gen = torch.Generator().manual_seed(0)
    modules = {"SDEGenerator": tsde.SDEGenerator(120, latent_dim=16, noise_dim=4, hidden=(32, 32),
                                                 generator=cpu_gen, device="cpu"),
               "CDEDiscriminator": tsde.CDEDiscriminator(120, generator=cpu_gen, device="cpu")}
    params = {}
    for name, module in modules.items():
        inits[name] = module.state_dict()
        params[name] = jax.tree.map(jnp.asarray,
                                    tconvert.state_dict_to_flax_params(module.state_dict()))

    def made(*args, **kw):
        _, *rest = make(*args, **kw)
        return (lambda key, batch, cond=None: (params["SDEGenerator"],
                                               params["CDEDiscriminator"]), *rest)
    return made


def _jitted_apply(apply):
    """A flax module's ``apply`` through ``jax.jit`` (the module and the
    path count static): the JAX SDE driver's evaluation draw runs op by op
    otherwise, seconds on a CPU; inside its jitted steps it is inlined."""
    jitted = jax.jit(lambda module, params, key, ts, batch, cond: apply(
        module, params, key, ts, batch, cond), static_argnums=(0, 4))

    def run(self, params, key, ts, batch, cond=None):
        return jitted(self, params, key, ts, batch, cond)
    return run


def _compare(family, data, tmp_path, monkeypatch, rows, epochs, batch, carried):
    """Run the JAX driver, recording the initial weights of each flax class
    of ``carried`` (``(flax class, port module, port class name)``; the SDE
    pair is the port's, handed to the JAX trainer); then the port's driver
    with those weights; compare the logs. Returns the port run's directory."""
    inits = {}
    with pytest.MonkeyPatch.context() as mp:
        if family == "sde":
            mp.setattr(jtrain_sde, "make_sde_gan_trainer", _sde_trainer(inits))
            mp.setattr(jsde.SDEGenerator, "apply", _jitted_apply(jsde.SDEGenerator.apply))
        else:
            for jcls, _, name in carried:
                mp.setattr(jcls, "init", _recording(jcls.init, inits, name))
        mp.setattr(jlog, "plot_losses", lambda *a, **k: None)
        assert jdrivers.run_training(family=family, data=data, data_stride=DATA_STRIDE,
                                     epochs=epochs, batch_size=batch,
                                     out_dir=str(tmp_path / "jax"), seed=0) == 0
    for _, module, name in carried:
        _carry(monkeypatch, module, name, inits[name])
    monkeypatch.setattr(tlog, "plot_losses", lambda *a, **k: None)
    assert tdrivers.run_training(family=family, data=data, data_stride=DATA_STRIDE, epochs=epochs,
                                 batch_size=batch, out_dir=str(tmp_path / "torch"), seed=0,
                                 device="cpu") == 0
    want = _log_rows(tmp_path / "jax" / family / "train_log.csv")
    got = _log_rows(tmp_path / "torch" / family / "train_log.csv")
    assert [r[:2] for r in got] == [r[:2] for r in want] == rows
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want], rtol=1e-3)
    run = tmp_path / "torch" / family
    for sub in ("jax", "torch"):  # the port's name table is the reference's
        assert (tmp_path / sub / family / f"{tdrivers.GENERATED[family]}.xyz").exists(), sub
    with open(tmp_path / "jax" / family / "eval.json") as fh:
        want_keys = json.load(fh).keys()
    with open(run / "eval.json") as fh:
        metrics = json.load(fh)
    assert metrics.keys() == want_keys
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["mean_abs_error"] < 100.0
    return run


def _split_draws(monkeypatch, key, dtype=None):
    """The port's draws from ``key`` as the JAX drivers take them: ``key,
    sub = split(key)``, a normal of the shape from ``sub`` in ``dtype``
    (None: JAX's default, float64 under the tests' x64)."""
    keys = {"key": key}

    def draw(gen, shape):
        keys["key"], sub = jax.random.split(keys["key"])
        return _f32(jax.random.normal(sub, tuple(shape), dtype))

    monkeypatch.setattr(tdrivers, "_noise", draw)


def test_flow_loop_matches_jax(data, tmp_path, monkeypatch):
    """Batch 4, ``MDX_FLOW_TEMB=2`` (Fourier features, float32 in both):
    16 updates, a row at 10. The sweep's base draw is the JAX driver's init
    key's normal."""
    monkeypatch.setenv("MDX_FLOW_TEMB", "2")
    monkeypatch.setenv("MDX_FLOW_HIDDEN", "64")
    monkeypatch.setattr(tdrivers, "_noise", lambda gen, shape: _f32(
        jax.random.normal(jax.random.PRNGKey(0), tuple(shape))))
    _compare("flow", data, tmp_path, monkeypatch, [(0, 10)], 1, 4,
             [(jflows.RealNVP, tflows, "RealNVP")])


def test_vae_loop_matches_jax(data, tmp_path, monkeypatch):
    """Batch 4: 16 updates, one reparameterisation key a batch, a row at 10."""
    _split_draws(monkeypatch, jax.random.PRNGKey(0), jnp.float32)  # the batch's dtype
    _compare("vae", data, tmp_path, monkeypatch, [(0, 10)], 1, 4,
             [(jvae.ConditionalVAE, tvae, "ConditionalVAE")])


def test_aae_loop_matches_jax(data, tmp_path, monkeypatch, capsys):
    """Batch 4, ``MDX_AAE_PROBE=1``: 16 autoencoder and 16 critic updates
    (the prior from each batch's key), a row at 10, then the probe on JAX's
    fixed draws (``PRNGKey(7)``): the same score."""
    monkeypatch.setenv("MDX_AAE_PROBE", "1")
    monkeypatch.setenv("MDX_AAE_NGEN", "20")
    _split_draws(monkeypatch, jax.random.split(jax.random.PRNGKey(0), 3)[0])
    monkeypatch.setattr(tdrivers, "_fixed_latents", lambda n, latent, device: _f32(
        jax.random.normal(jax.random.PRNGKey(7), (n, latent))))
    _compare("aae", data, tmp_path, monkeypatch, [(0, 10)], 1, 4,
             [(jae.MLPAutoencoder, tae, "MLPAutoencoder"),
              (jae.LatentDiscriminator, tae, "LatentDiscriminator")])
    probes = [float(v) for v in re.findall(r"aae probe epoch 1: e2e=([0-9.]+)",
                                           capsys.readouterr().out)]
    assert len(probes) == 2
    assert probes[1] == pytest.approx(probes[0], rel=1e-2, abs=2e-3)


def test_sde_loop_matches_jax(data, tmp_path, monkeypatch):
    """Batch 3 over 14 windows, 3 epochs: 12 batches (one generator and
    three critic updates each, the potential injection at the 10th, weight
    averaging from the 7th), the last critic loss logged at 10. Each
    batch's draws come from ``key, k1, k2, k3 = split(key, 4)``: the
    generator's paths from ``k1``, each critic update's paths and
    interpolation weights from a split of ``k2`` in three, the injection's
    paths from ``k3``; a path's ``z0`` and ``dw`` from a split of its key.
    Both learning rates are 1e-5: at the driver's defaults the critic's
    loss grows by orders of magnitude within ten batches (as in the JAX
    package's own committed run, ``runs_r3/sde/train_log.csv``) and float32
    rounding alone moves it by as much, in either package. The eval.json
    carries the data's TV floor."""
    for knob, value in (("MDX_SDE_HIDDEN", "32"), ("MDX_SDE_LATENT", "16"),
                        ("MDX_SDE_NOISE", "4"), ("MDX_SDE_PROBE", "0"),
                        ("MDX_SDE_LR_G", "1e-5"), ("MDX_SDE_LR_D", "1e-5")):
        monkeypatch.setenv(knob, value)
    state = {"key": jax.random.PRNGKey(0), "queue": [], "batch": -1}

    def path_key(n_paths):
        """The key of the next path draw: the evaluation's 1,024 paths from
        ``key, sub = split(key)``; else the batch's next key, a new batch
        where the last one's keys are spent (its ``k3`` unless the batch
        injected)."""
        if n_paths == 1024:
            state["key"], sub = jax.random.split(state["key"])
            return sub
        queue = state["queue"]
        if not queue or (queue[0][0] == "i" and state["batch"] % 10 != 9):
            state["batch"] += 1
            state["key"], k1, k2, k3 = jax.random.split(state["key"], 4)
            queue[:] = [("g", k1)] + [("d", k) for k in jax.random.split(k2, 3)] + [("i", k3)]
        kind, key = queue.pop(0)
        if kind == "d":
            key, state["eps_key"] = jax.random.split(key)
        return key

    def noise(gen, shape):
        shape = tuple(shape)
        if len(shape) == 2:  # a path's z0 (B, init_noise_dim); its dw (T-1, B, noise) follows
            k_init, state["dw_key"] = jax.random.split(path_key(shape[0]))
            return _f32(jax.random.normal(k_init, shape))
        return _f32(jax.random.normal(state["dw_key"], shape))

    monkeypatch.setattr(tdrivers, "_noise", noise)
    monkeypatch.setattr(tdrivers, "_uniform", lambda gen, shape: _f32(
        jax.random.uniform(state["eps_key"], tuple(shape))))
    run = _compare("sde", data, tmp_path, monkeypatch, [(2, 10)], 3, 3,
                   [(jsde.SDEGenerator, tsde, "SDEGenerator"),
                    (jsde.CDEDiscriminator, tsde, "CDEDiscriminator")])
    with open(run / "eval.json") as fh:
        metrics = json.load(fh)
    assert 0.0 <= metrics["marginal_tv_mean"] <= 1.0
    assert 0.0 <= metrics["marginal_tv_floor"] <= 1.0
    state_dict = torch.load(run / "best.ckpt", weights_only=True)
    assert any(k.startswith("drift.") for k in state_dict)  # the averaged generator


def test_cli_train_sde_runs_the_probe(data, tmp_path, capsys):
    """``cli train sde`` with its default probe (every epoch) and widths:
    the probe prints, eval.json carries the marginal TV and its floor."""
    assert tcli.main(["train", "sde", "--device", "cpu", "--data", data, "--stride", "10",
                      "--epochs", "1", "--batch-size", "4", "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "sde probe epoch 1: tv=" in out and "sde eval:" in out
    with open(tmp_path / "sde" / "eval.json") as fh:
        metrics = json.load(fh)
    assert {"marginal_tv_mean", "marginal_tv_max", "marginal_tv_floor"} <= metrics.keys()
    assert (tmp_path / "sde" / "SDE_generated.pdb").exists()
