"""Port parity: the training loops of four sequence and graph drivers
against the JAX drivers', from JAX's initial weights and draws.

The four loop kinds of the line: ``lstm`` (windows, then the unrolled
fine-tune), ``seq2seq-gan`` (two optimizers, two draws a batch), ``gat``
(input noise a batch, then the unrolled fine-tune) and ``seq2seq-graph``
(one key a row, torsions from the raw geometry, then the chained
fine-tune with the torsion channels rebuilt). Float32 in both packages, on
2 synthetic backbone trajectories of 30 frames, 1 epoch, seed 0, the
fine-tunes cut to short windows and few epochs through their knobs: the same numpy batches,
phases, rebase and logging cadence give the same logged losses, within
1e-3 relative. The port's modules start from the weights JAX's driver
initialises (recorded from its own ``init`` calls), and the port
driver's training draws (``drivers._noise``) replay JAX's: the keys the JAX
driver splits, in its order. Only the loops are compared: JAX's generation
rollouts are replaced by constant ones where they are library functions
(their parity is in ``test_torch_seq_train.py``) and its loss plot
skipped.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molecular_dynamics_tpu.log as jlog
from molecular_dynamics_tpu.models import gat as jgat
from molecular_dynamics_tpu.models import seq as jseq
from molecular_dynamics_tpu.train import drivers as jdrivers
from molecular_dynamics_tpu.train import seq as jtrain
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.examples import decaalanine_backbone
from molecular_dynamics_tpu_torch.models import gat as tgat
from molecular_dynamics_tpu_torch.models import seq as tseq
from molecular_dynamics_tpu_torch.train import drivers as tdrivers

import torch_parity  # noqa: F401  (one torch thread a test worker)


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


def _constant(x0, n):
    return jnp.broadcast_to(x0, (n,) + x0.shape)


def _compare(family, data, tmp_path, monkeypatch, rows, epochs, batch, carried, constant=None):
    """Run the JAX driver, recording the initial weights of each flax class
    of ``carried`` (``(flax class, port module, port class name)``) as its
    driver makes them; then the port's driver, its modules built with those
    weights; then compare the logs."""
    inits = {}
    with pytest.MonkeyPatch.context() as mp:
        for jcls, _, name in carried:
            mp.setattr(jcls, "init", _recording(jcls.init, inits, name))
        if constant is not None:
            mp.setattr(jtrain, *constant)
        mp.setattr(jlog, "plot_losses", lambda *a, **k: None)
        assert jdrivers.run_training(family=family, data=data, epochs=epochs, batch_size=batch,
                                     out_dir=str(tmp_path / "jax"), seed=0) == 0
    for _, module, name in carried:
        _carry(monkeypatch, module, name, inits[name])
    assert tdrivers.run_training(family=family, data=data, epochs=epochs, batch_size=batch,
                                 out_dir=str(tmp_path / "torch"), seed=0, device="cpu") == 0
    for sub in ("jax", "torch"):  # the port's name table is the reference's
        assert (tmp_path / sub / family / f"{tdrivers.GENERATED[family]}.xyz").exists(), sub
    want = _log_rows(tmp_path / "jax" / family / "train_log.csv")
    got = _log_rows(tmp_path / "torch" / family / "train_log.csv")
    assert [r[:2] for r in got] == [r[:2] for r in want] == rows
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want], rtol=1e-3)


def _recording(init, inits, name):
    """``init``, jitted (the same weights; op by op it takes seconds),
    recording what it returns under ``name``."""
    def recorded(self, *args, **kw):
        static = tuple(i for i, a in enumerate(args) if isinstance(a, int))
        params = jax.jit(lambda *a: init(self, *a, **kw), static_argnums=static)(*args)
        inits[name] = tconvert.flax_params_to_state_dict(
            jax.tree.map(np.asarray, params), torch.float32)
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


def _replay(monkeypatch, draw):
    """Route the port driver's training draws through ``draw(shape)``."""
    monkeypatch.setattr(tdrivers, "_noise", lambda gen, shape: torch.as_tensor(
        np.asarray(draw(tuple(shape)), np.float32)))


def test_lstm_loop_matches_jax(data, tmp_path, monkeypatch):
    """Batch 2: 14 window updates, then 6 of 2-frame rollouts
    (``MDX_LSTM_FT_W=2``, one epoch): rows at 10 | 20, the second logged
    at epoch 1 after the rebase."""
    monkeypatch.setenv("MDX_LSTM_FT_W", "2")
    monkeypatch.setenv("MDX_LSTM_FT_EPOCHS", "1")
    _compare("lstm", data, tmp_path, monkeypatch, [(0, 10), (1, 20)], 1, 2,
             [(jseq.LSTMPredictor, tseq, "LSTMPredictor")], constant=("autoregressive_rollout",
                       lambda model, params, w, n_steps, corrector=None: _constant(w[-1], n_steps)))


def test_seq2seq_gan_loop_matches_jax(data, tmp_path, monkeypatch):
    """Batch 3 (every batch full, so that JAX compiles each step once): 10
    generator and 10 critic updates, the generator's loss logged at 10; the
    draws of each batch split three ways from the key."""
    key, _, _ = jax.random.split(jax.random.PRNGKey(0), 3)  # the driver's; kg, kd init
    keys = {"key": key, "pending": None}

    def draw(shape):
        if keys["pending"] is None:  # the g step's draw: split the batch's keys
            keys["key"], k1, keys["pending"] = jax.random.split(keys["key"], 3)
            return jax.random.normal(k1, shape, jnp.float32)
        k2, keys["pending"] = keys["pending"], None
        return jax.random.normal(k2, shape, jnp.float32)

    _replay(monkeypatch, draw)
    _compare("seq2seq-gan", data, tmp_path, monkeypatch, [(0, 10)], 1, 3,
             [(jseq.Seq2Seq, tseq, "Seq2Seq"),
              (jseq.SequenceDiscriminator, tseq, "SequenceDiscriminator")], constant=("chained_decode_rollout",
                       lambda model, params, w, k, dl, n, corrector=None: _constant(w[-1], n)))


def test_gat_loop_matches_jax(data, tmp_path, monkeypatch):
    """Batch 4: 13 noisy GNS updates, then 12 of 2-step unrolls
    (``MDX_GAT_FT_W=2``, one epoch): rows at 10 | 20. The input noise is
    JAX's default-dtype normal of each batch's subkey. The JAX driver's
    rollout is its own jitted scan and runs as it is."""
    monkeypatch.setenv("MDX_GAT_FT_W", "2")
    monkeypatch.setenv("MDX_GAT_FT_EPOCHS", "1")
    keys = {"key": jax.random.PRNGKey(0)}

    def draw(shape):
        keys["key"], sub = jax.random.split(keys["key"])
        return jax.random.normal(sub, shape)

    _replay(monkeypatch, draw)
    _compare("gat", data, tmp_path, monkeypatch, [(0, 10), (1, 20)], 1, 4,
             [(jgat.GATSimulator, tgat, "GATSimulator")])


def test_seq2seq_graph_loop_matches_jax(data, tmp_path, monkeypatch):
    """Batch 3 (every batch full): 10 updates, one key a row; then 12 of a
    one-segment chained fine-tune (``MDX_GSEQ_FT_SEGS=1``, three epochs of
    four) through the torsion refeaturizer: rows at 10 | 20, the second in
    the fine-tune's third epoch."""
    monkeypatch.setenv("MDX_GSEQ_FT_SEGS", "1")
    monkeypatch.setenv("MDX_GSEQ_FT_EPOCHS", "3")
    keys = {"key": jax.random.PRNGKey(0)}

    def draw(shape):
        keys["key"], sub = jax.random.split(keys["key"])
        rows = jax.random.split(sub, shape[0])
        if len(shape) == 4:  # a training batch: (B, L, N, F), one key a row
            return np.stack([jax.random.normal(k, shape[1:], jnp.float32) for k in rows])
        out = []  # the fine-tune: (B, S, L, N, F), S keys split off each row's
        for k in rows:
            segs = []
            for _ in range(shape[1]):
                k, s = jax.random.split(k)
                segs.append(jax.random.normal(s, shape[2:], jnp.float32))
            out.append(np.stack(segs))
        return np.stack(out)

    _replay(monkeypatch, draw)
    _compare("seq2seq-graph", data, tmp_path, monkeypatch, [(0, 10), (3, 20)], 1, 3,
             [(jgat.GraphSeq2Seq, tgat, "GraphSeq2Seq")], constant=("graph_chained_decode_rollout",
                       lambda model, params, w, k, dl, n, refeature=None:
                       _constant(jnp.swapaxes(w, 0, 1)[-1], n)))
