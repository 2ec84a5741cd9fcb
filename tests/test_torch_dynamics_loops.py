"""Port parity: the training loops of the ``node`` and ``hnn`` drivers
against the JAX drivers', from JAX's initial weights.

Float32 in both packages, on 2 synthetic backbone trajectories of 30 frames,
3 epochs of batch 4, seed 0: the same numpy batches, phases (``node``: RK4
steps, then the chained-solver fine-tune; ``hnn``: L2 with every 10th update
potential-informed, then the 10-step unroll), rebase and logging cadence
give the same logged losses, within 1e-3 relative. Only the loops are
compared: JAX's generation rollouts are replaced by constant ones (its
solvers have tests of their own) and its loss plot skipped, to keep the
tests short. ``hnn-schnet`` runs the ``hnn`` loop with the SchNet field,
whose updates ``test_torch_node.py`` holds to JAX's.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molecular_dynamics_tpu.log as jlog
from molecular_dynamics_tpu.models import hnn as jhnn
from molecular_dynamics_tpu.models import node as jnode
from molecular_dynamics_tpu.train import drivers as jdrivers
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.examples import decaalanine_backbone
from molecular_dynamics_tpu_torch.models import hnn as thnn
from molecular_dynamics_tpu_torch.train import drivers as tdrivers

import torch_parity  # noqa: F401  (one torch thread a test worker)

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
