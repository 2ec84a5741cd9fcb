"""Port parity: the training loops of the ``node`` and ``hnn`` drivers
against the JAX drivers', from JAX's initial weights.

Float32 in both packages, on 2 synthetic backbone trajectories of 30 frames,
3 epochs of batch 4, seed 0: the same numpy batches, phases (``node``: RK4
steps, then the chained-solver fine-tune; ``hnn``: L2 with every 10th update
potential-informed, then the 10-step unroll), rebase and logging cadence
give the same logged losses, within 1e-3 relative. Only the loops are
compared: JAX's generation rollouts are replaced by constant ones (its
solvers have tests of their own) and its loss plot skipped, to keep the
tests short. ``hnn-schnet`` runs the ``hnn`` loop with the SchNet field
and, by default, the probe selection over the unroll phase's snapshots: its
test runs the real rollouts, and compares the checkpoint each package's
probe selection chooses and the eval.json of the chosen weights too.
"""

import csv
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molecular_dynamics_tpu.log as jlog
from molecular_dynamics_tpu.models import hnn as jhnn
from molecular_dynamics_tpu.models import node as jnode
from molecular_dynamics_tpu.models import schnet as jschnet
from molecular_dynamics_tpu.train import drivers as jdrivers
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.examples import decaalanine_backbone, dialanine
from molecular_dynamics_tpu_torch.models import hnn as thnn
from molecular_dynamics_tpu_torch.models import schnet as tschnet
from molecular_dynamics_tpu_torch.train import drivers as tdrivers

import torch_parity  # one torch thread a test worker

DIM = 2 * 40 * 3  # (q, p) rows of the 40-atom backbone


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    top, coords = decaalanine_backbone()
    rng = np.random.default_rng(1)
    root = tmp_path_factory.mktemp("data")
    for r in range(2):
        frames = np.asarray(coords)[None] + 0.3 * rng.standard_normal(
            (30, top.n_atoms, 3)).astype(np.float32)
        np.save(root / f"traj-{r}.npy", frames.astype(np.float32))
    return str(root / "*.npy")


@pytest.fixture(scope="module")
def short_data(tmp_path_factory):
    """2 synthetic di-alanine trajectories (22 atoms) of 18 and 5 frames:
    19 phase-space rows and 6 unroll windows, all in the first."""
    _, coords, _ = dialanine(device="cpu")
    rng = np.random.default_rng(2)
    root = tmp_path_factory.mktemp("short")
    for r, n_frames in enumerate((18, 5)):
        frames = np.asarray(coords)[None] + 0.3 * rng.standard_normal(
            (n_frames, len(coords), 3)).astype(np.float32)
        np.save(root / f"traj-{r}.npy", frames.astype(np.float32))
    return str(root / "*.npy")


def _log_rows(path):
    with open(path) as fh:
        return [(int(r["epoch"]), int(r["step"]), float(r["loss"])) for r in csv.DictReader(fh)]


def _compare(family, data, tmp_path, monkeypatch, rows):
    constant = {"node": (jnode, "rk4_rollout", lambda field, x0, n_steps, dt, **kw:
                         jnp.broadcast_to(x0, (n_steps,) + x0.shape)),
                "hnn": (jhnn, "rollout", lambda model, params, x0, n_steps, **kw:
                        jnp.broadcast_to(x0, (n_steps,) + x0.shape))}[family]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(*constant)
        mp.setattr(jlog, "plot_losses", lambda *a, **k: None)
        assert jdrivers.run_training(family=family, data=data, epochs=3, batch_size=4,
                                     out_dir=str(tmp_path / "jax"), seed=0) == 0
    init = jax.jit(jhnn.HNN(hidden=(200, 200)).init)(jax.random.PRNGKey(0), jnp.zeros((DIM,)))
    state = tconvert.flax_params_to_state_dict(jax.tree.map(np.asarray, init), torch.float32)
    built, hnn_cls = [], thnn.HNN

    def carried(*args, **kw):
        module = hnn_cls(*args, **kw)
        module.load_state_dict(state)
        built.append(module)
        return module

    monkeypatch.setattr(thnn, "HNN", carried)
    tdrivers.run_training(family=family, data=data, epochs=3, batch_size=4,
                          out_dir=str(tmp_path / "torch"), seed=0, device="cpu")
    assert len(built) == 1
    for sub in ("jax", "torch"):  # the port's name table is the reference's
        assert (tmp_path / sub / family / f"{tdrivers.GENERATED[family]}.xyz").exists(), sub
    want = _log_rows(tmp_path / "jax" / family / "train_log.csv")
    got = _log_rows(tmp_path / "torch" / family / "train_log.csv")
    assert [r[:2] for r in got] == [r[:2] for r in want] == rows
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want], rtol=1e-3)


def test_node_driver_matches_jax(data, tmp_path, monkeypatch):
    """28 RK4-step updates, then 12 of a 3-frame fine-tune
    (``MDX_NODE_SEQ=3``, read by both drivers): rows at 10, 20 | 30, 40;
    the probe selection after it meets final weights equal to its last
    snapshot."""
    monkeypatch.setenv("MDX_NODE_SEQ", "3")
    _compare("node", data, tmp_path, monkeypatch, [(0, 10), (1, 20), (2, 30), (2, 40)])


def test_hnn_driver_matches_jax(data, tmp_path, monkeypatch):
    """28 updates of L2 (the 10th and 20th potential-informed), then 9 of
    the 10-step unroll: rows at 10, 20 | 30."""
    _compare("hnn", data, tmp_path, monkeypatch, [(0, 10), (1, 20), (2, 30)])


#: the probe selection's line, as both drivers print it
PROBE_LINE = re.compile(r"hnn probe selection: checkpoint (\d+)/(\d+)")


def test_hnn_schnet_probe_selection_matches_jax(short_data, tmp_path, monkeypatch, capfd):
    """Batch 2, 2 epochs: 9 L2 updates (none potential-informed: the
    ``hnn`` test has that step), then 3 of the 10-step unroll: a row at 10.
    ``MDX_HNN_PROBE=1`` snapshots every unroll update and the epoch's end (4
    snapshots, the last two equal to the final weights, which take their
    score without a probe run); each candidate is probed by the real
    11-frame rollouts of the 2 starts. The packages choose the same
    checkpoint of the same 5, and the chosen weights' eval.json agrees
    within 2e-3 A. The 22-atom di-alanine keeps the SchNet updates short."""
    monkeypatch.setenv("MDX_HNN_PROBE", "1")
    inits = {}
    init = jschnet.SchNetHNN.init

    def recorded(self, *args, **kw):
        params = jax.jit(lambda *a: init(self, *a, **kw))(*args)
        inits["state"] = tconvert.flax_params_to_state_dict(
            jax.tree.map(np.asarray, params), torch.float32)
        return params

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jschnet.SchNetHNN, "init", recorded)
        # jitted once: op by op the scan is traced anew at each probe call
        mp.setattr(jhnn, "rollout", torch_parity.jitted_rollout(jhnn.rollout))
        mp.setattr(jlog, "plot_losses", lambda *a, **k: None)
        assert jdrivers.run_training(family="hnn-schnet", data=short_data, epochs=2,
                                     batch_size=2, topology="example:diala",
                                     out_dir=str(tmp_path / "jax"), seed=0) == 0
    want_line = PROBE_LINE.findall(capfd.readouterr().out)
    cls = tschnet.SchNetHNN

    def carried(*args, **kw):
        module = cls(*args, **kw)
        module.load_state_dict(inits["state"])
        return module

    monkeypatch.setattr(tschnet, "SchNetHNN", carried)
    assert tdrivers.run_training(family="hnn-schnet", data=short_data, epochs=2, batch_size=2,
                                 topology="example:diala",
                                 out_dir=str(tmp_path / "torch"), seed=0, device="cpu") == 0
    got_line = PROBE_LINE.findall(capfd.readouterr().out)
    assert got_line == want_line and len(want_line) == 1 and want_line[0][1] == "5", (
        got_line, want_line)
    want = _log_rows(tmp_path / "jax" / "hnn-schnet" / "train_log.csv")
    got = _log_rows(tmp_path / "torch" / "hnn-schnet" / "train_log.csv")
    assert [r[:2] for r in got] == [r[:2] for r in want] == [(1, 10)]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want], rtol=1e-3)
    want, got = (json.loads((tmp_path / sub / "hnn-schnet" / "eval.json").read_text())
                 for sub in ("jax", "torch"))
    assert sorted(got) == sorted(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 2e-3, (key, got[key], want[key])
