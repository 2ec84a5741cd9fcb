"""Port parity: the Hamiltonian dynamics line end to end on the CPU at tiny
sizes: the drivers (``hnn``, ``hnn-schnet``, ``hnn-latent``, ``node``),
their evaluation epilogue, the rollout correctors and ``write_vmd_loader``.

``run_training`` for each family on synthetic backbone data (two
trajectories of 60 frames, 1 epoch, batch 8, as the JAX package's driver
test runs them; ``hnn-schnet`` on every second frame, batch 4) writes the log, ``best.ckpt``, the generated ``.xyz`` /
``.pdb`` and an ``eval.json`` with finite values under the 100 A sanity
bound (the ``node`` and ``hnn`` loops against the JAX drivers' are in
``test_torch_dynamics_loops.py``). The rollout-ensemble epilogue, the spread-aware probe score and the whitening
equal JAX's to 1e-12 relative. The FIRE corrector equals JAX's in float64
to 1e-9 (free and pinned); the Langevin corrector, whose noise is the
port's own, meets the JAX package's own checks (lower energy, the trust
region, the pinned colvar, one output a frame); the corrector grammar
raises JAX's errors. ``write_vmd_loader`` writes JAX's bytes.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_tpu.train import datasets as jdata
from molecular_dynamics_tpu.train import drivers as jdrivers
from molecular_dynamics_tpu.train import seq as jseq
from molecular_dynamics_tpu.utils import vmd as jvmd
from molecular_dynamics_tpu_torch import cli as tcli
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.energy import total_energy
from molecular_dynamics_tpu_torch.examples import decaalanine_backbone
from molecular_dynamics_tpu_torch.train import datasets as tdata
from molecular_dynamics_tpu_torch.train import drivers as tdrivers
from molecular_dynamics_tpu_torch.train import seq as tseq
from molecular_dynamics_tpu_torch.utils import write_vmd_loader

from torch_parity import ff_to_numpy, t

F64 = torch.float64
FAMILIES = ("hnn", "hnn-latent", "hnn-schnet", "node")


def _synthetic(root, n_frames, seed=0):
    top, coords = decaalanine_backbone()
    rng = np.random.default_rng(seed)
    root.mkdir(exist_ok=True)
    for r in range(2):
        frames = np.asarray(coords)[None] + 0.3 * rng.standard_normal(
            (n_frames, top.n_atoms, 3)).astype(np.float32)
        np.save(root / f"traj-{r}.npy", frames.astype(np.float32))
    return str(root / "*.npy")


@pytest.fixture(scope="module")
def data_glob(tmp_path_factory):
    return _synthetic(tmp_path_factory.mktemp("data"), 60)


# -- the drivers -------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_run_training(family, data_glob, tmp_path):
    # SchNet's (8, 40, 40, 64) filters, differentiated twice, take about 0.7 s
    # an update on one CPU thread: every second frame in batches of 4 (14
    # updates, so that the 10th is logged) keeps the test short
    stride, batch = (2, 4) if family == "hnn-schnet" else (1, 8)
    assert tdrivers.run_training(family=family, data=data_glob, data_stride=stride, epochs=1,
                                 batch_size=batch, out_dir=str(tmp_path), seed=0,
                                 device="cpu") == 0
    run = tmp_path / family
    generated = tdrivers.GENERATED[family]
    for name in ("train_log.csv", "best.ckpt", f"{generated}.xyz", f"{generated}.pdb",
                 "eval.json"):
        assert (run / name).exists(), name
    with open(run / "eval.json") as fh:
        metrics = json.load(fh)
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["mean_abs_error"] < 100.0
    with open(run / "train_log.csv") as fh:
        losses = [float(r["loss"]) for r in csv.DictReader(fh)]
    assert losses and np.isfinite(losses).all()
    # best.ckpt holds the weights the evaluation rolled out
    state = torch.load(run / "best.ckpt", weights_only=True)
    assert all(torch.isfinite(v).all() for v in state.values())


def test_cli_train_hnn_and_the_queued_families(data_glob, tmp_path, capsys):
    assert tcli.main(["train", "hnn", "--device", "cpu", "--data", data_glob, "--epochs", "1",
                      "--batch-size", "8", "--stride", "2", "--out-dir", str(tmp_path)]) == 0
    assert "hnn eval:" in capsys.readouterr().out
    assert (tmp_path / "hnn" / "eval.json").exists()
    # and vae, queued until the generative line was ported
    assert tcli.main(["train", "vae", "--device", "cpu", "--data", data_glob, "--epochs", "1",
                      "--batch-size", "8", "--out-dir", str(tmp_path)]) == 0
    assert "vae eval:" in capsys.readouterr().out


def test_probe_selection_skips_a_repeated_final(capsys):
    """The final weights equal to the last snapshot are not rolled out
    again, and the choice is the one scoring both would make."""
    model = torch.nn.Linear(2, 1)
    snaps = []
    for value in (3.0, 1.0, 2.0):
        with torch.no_grad():
            model.weight.fill_(value)
        tdrivers._snapshot(snaps, model)
    calls = []

    def score():
        calls.append(float(model.weight.detach()[0, 0]))
        return abs(calls[-1] - 1.5)

    tdrivers._probe_select("node", model, snaps, score)
    assert calls == [3.0, 1.0, 2.0] and float(model.weight.detach()[0, 0]) == 1.0
    assert "checkpoint 2/4 score 0.500 (final-params score 0.500)" in capsys.readouterr().out
    with torch.no_grad():
        model.weight.fill_(1.5)  # final weights of their own: rolled out, and best
    tdrivers._probe_select("node", model, snaps, score)
    assert calls[3:] == [3.0, 1.0, 2.0, 1.5] and float(model.weight.detach()[0, 0]) == 1.5


def test_rollout_epilogue_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    _, coords = decaalanine_backbone()
    trajs = [np.asarray(coords)[None] + 0.4 * rng.standard_normal((25, 40, 3)) for _ in range(3)]
    rolls = [np.asarray(coords)[None] + 0.5 * rng.standard_normal((20, 40, 3)) for _ in range(2)]
    jtraj = jdata.TrajectoryData([a.astype(np.float32) for a in trajs])
    ttraj = tdata.TrajectoryData([a.astype(np.float32) for a in trajs])
    for sub in ("jax", "torch"):
        (tmp_path / sub).mkdir()
    want = jdrivers._eval_rollout_ensemble(str(tmp_path / "jax"), "node", rolls, jtraj,
                                           extra={"note": 1.0})
    got = tdrivers._eval_rollout_ensemble(str(tmp_path / "torch"), "node", rolls, ttraj,
                                          extra={"note": 1.0})
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert (tmp_path / "torch" / "eval.json").read_text() == (tmp_path / "jax" / "eval.json").read_text()
    assert tdrivers._ensemble_probe_score(rolls, ttraj, 6.0) == pytest.approx(
        jdrivers._ensemble_probe_score(rolls, jtraj, 6.0), rel=1e-12)
    (jw, jm, js), (tw, tm, ts) = jdrivers._whitened(jtraj), tdrivers._whitened(ttraj)
    for a, b in zip(tw.trajectories, jw.trajectories):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ts, js)


# -- the correctors ----------------------------------------------------------------


@pytest.fixture(scope="module")
def corrector_system(backbone_system):
    top, jff, coords = backbone_system
    tff = tconvert.ff_params_from_numpy(ff_to_numpy(jff), device="cpu", dtype=F64)
    n = jff.n_atoms
    noisy = np.asarray(coords, np.float64) + 0.3 * np.random.default_rng(1).standard_normal((n, 3))
    return jff, tff, noisy.reshape(-1), np.zeros(3 * n), np.ones(3 * n)


@pytest.mark.parametrize("pinned", [False, True])
def test_fire_corrector_matches_jax(pinned, corrector_system):
    jff, tff, flat, mean, std = corrector_system
    n = jff.n_atoms
    kw = dict(n_steps=24, pin_groups=(0, n - 1), pin_fk=200.0) if pinned else dict(n_steps=24)
    want = np.asarray(jax.jit(jseq.make_frame_corrector(jff, mean, std, **kw))(jnp.asarray(flat)))
    got = tseq.make_frame_corrector(tff, mean, std, **kw)(t(flat))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9 * np.abs(want).max())
    # rows of a batch are corrected one by one
    both = tseq.make_frame_corrector(tff, mean, std, **kw)(t(np.stack([flat, flat])))
    assert torch.equal(both[0], got) and torch.equal(both[1], got)

    def e2e(q):
        q = np.asarray(q).reshape(n, 3)
        return float(np.linalg.norm(q[-1] - q[0]))

    assert float(np.abs(got.numpy() - flat).max()) <= 24 * 0.05 + 1e-9  # the trust region
    if pinned:
        assert abs(e2e(got) - e2e(flat)) < 0.15


def test_langevin_corrector(corrector_system):
    jff, tff, flat, mean, std = corrector_system
    n = jff.n_atoms
    correct = tseq.make_langevin_corrector(tff, mean, std, n_steps=20, pin_groups=(0, n - 1),
                                           pin_fk=200.0)
    out = correct(t(flat))

    def energy(q):
        return float(total_energy(q.reshape(n, 3), tff))

    def e2e(q):
        q = q.reshape(n, 3)
        return float(torch.linalg.norm(q[-1] - q[0]))

    assert torch.isfinite(out).all()
    assert energy(out) < energy(t(flat))
    assert float((out - t(flat)).abs().max()) <= 20 * 0.05 + 1e-9
    assert abs(e2e(out) - e2e(t(flat))) < 0.5
    assert torch.equal(correct(t(flat)), out)  # one output a frame
    other = correct(t(flat + 1e-3))
    assert not torch.equal(other, out)  # another frame, another stream


def test_corrector_grammar(corrector_system, monkeypatch):
    jff, tff, _, z, o = corrector_system
    monkeypatch.delenv("MDX_ROLLOUT_CORRECT", raising=False)
    assert tseq.corrector_from_env(tff, z, o) is None
    for spec in ("", "none"):
        assert tseq.corrector_from_spec(tff, z, o, spec) is None
    for spec in ("fire:4", "fire:4:pin100", "langevin:6:pin", "fire::pin"):
        monkeypatch.setenv("MDX_ROLLOUT_CORRECT", spec)
        assert callable(tseq.corrector_from_env(tff, z, o))
    for spec in ("bogus:8", "fire:4:bogus"):
        monkeypatch.setenv("MDX_ROLLOUT_CORRECT", spec)
        with pytest.raises(ValueError) as want:
            jseq.corrector_from_env(jff, z, o)
        with pytest.raises(ValueError) as got:
            tseq.corrector_from_env(tff, z, o)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="MDX_ROLLOUT_CORRECT mode must be 'fire' or 'langevin', got 'bogus'"):
        tseq.corrector_from_spec(tff, z, o, "bogus:8", what="MDX_ROLLOUT_CORRECT")


# -- utils -------------------------------------------------------------------------


@pytest.mark.parametrize("topology", [None, "backbone.psf"])
def test_vmd_loader_bytes(topology, tmp_path):
    trajs = ["runs/hnn/HNN_generated.xyz", "runs/node/NODE_generated.xyz"]
    want = jvmd.write_vmd_loader(str(tmp_path / "jax.tcl"), trajs, topology=topology,
                                 representation="Lines")
    got = write_vmd_loader(str(tmp_path / "torch.tcl"), trajs, topology=topology,
                           representation="Lines")
    assert got.endswith("torch.tcl") and want.endswith("jax.tcl")
    assert (tmp_path / "torch.tcl").read_bytes() == (tmp_path / "jax.tcl").read_bytes()
