"""Port: the sequence and graph drivers end to end on the CPU at tiny sizes.

``run_training`` for each of the eight families (``lstm``, ``lstm-nll``,
``seq2seq``, ``seq2seq-gan``, ``transformer``, ``gat``, ``lstm-gat``,
``seq2seq-graph``) on synthetic backbone data (two trajectories of 30
frames, 1 epoch, a batch that makes at least 10 updates, the fine-tunes
cut to one epoch through their knobs) writes the log, ``best.ckpt``, the
generated ``.xyz`` / ``.pdb`` under the reference's stem and an
``eval.json`` with finite values under the 100 A sanity bound. ``lstm``
runs with ``MDX_LSTM_PROBE=1`` (its probe selection, and ``best.ckpt``
holding the chosen weights); ``lstm-nll`` warns that it ignores the knob.
The loops themselves are held to the JAX drivers' in
``test_torch_seq_loops.py``; the command line's ``train`` takes the
families, and still refuses A13's.
"""

import csv
import json

import numpy as np
import pytest
import torch

from molecular_dynamics_tpu_torch import cli as tcli
from molecular_dynamics_tpu_torch.examples import decaalanine_backbone
from molecular_dynamics_tpu_torch.train import drivers as tdrivers

import torch_parity  # noqa: F401  (one torch thread a test worker)

#: the batch of each family's run (at least 10 updates on 2 x 30 frames)
BATCH = {"lstm": 2, "lstm-nll": 2, "seq2seq": 3, "seq2seq-gan": 3, "transformer": 2, "gat": 4,
         "lstm-gat": 4, "seq2seq-graph": 3}
FT_KNOBS = ("MDX_LSTM_FT_EPOCHS", "MDX_TRANSFORMER_FT_EPOCHS", "MDX_GAT_FT_EPOCHS",
            "MDX_LSTMGAT_FT_EPOCHS", "MDX_GSEQ_FT_EPOCHS")


@pytest.fixture(scope="module")
def data_glob(tmp_path_factory):
    top, coords = decaalanine_backbone()
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("data")
    for r in range(2):
        frames = np.asarray(coords)[None] + 0.3 * rng.standard_normal(
            (30, top.n_atoms, 3)).astype(np.float32)
        np.save(root / f"traj-{r}.npy", frames.astype(np.float32))
    return str(root / "*.npy")


@pytest.mark.parametrize("family", sorted(BATCH))
def test_run_training(family, data_glob, tmp_path, monkeypatch, capsys):
    for knob in FT_KNOBS:
        monkeypatch.setenv(knob, "1")
    monkeypatch.setenv("MDX_GSEQ_FT_SEGS", "1")  # 4 x 5 frames leave no window in 30
    monkeypatch.setenv("MDX_LSTM_PROBE", "1")
    kw = dict(family=family, data=data_glob, epochs=1, batch_size=BATCH[family],
              out_dir=str(tmp_path), seed=0, device="cpu")
    if family == "lstm-nll":
        with pytest.warns(UserWarning, match="MDX_LSTM_PROBE is ignored by lstm-nll"):
            assert tdrivers.run_training(**kw) == 0
    else:
        assert tdrivers.run_training(**kw) == 0
    run = tmp_path / family
    generated = tdrivers.GENERATED[family]
    for name in ("train_log.csv", "best.ckpt", f"{generated}.xyz", f"{generated}.pdb",
                 "eval.json", "loss.png"):
        assert (run / name).exists(), name
    with open(run / "eval.json") as fh:
        metrics = json.load(fh)
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["mean_abs_error"] < 100.0
    with open(run / "train_log.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert rows and np.isfinite([float(r["loss"]) for r in rows]).all()
    state = torch.load(run / "best.ckpt", weights_only=True)
    assert all(torch.isfinite(v).all() for v in state.values())
    if family == "lstm":  # one epoch-end snapshot and the final weights, equal: one probe
        out = capsys.readouterr().out
        assert "lstm probe selection: checkpoint 1/2" in out
        assert "lstm eval:" in out


def test_cli_train_takes_the_line_and_refuses_a13(data_glob, tmp_path, capsys):
    assert tcli.main(["train", "seq2seq", "--device", "cpu", "--data", data_glob, "--epochs", "1",
                      "--batch-size", "3", "--out-dir", str(tmp_path)]) == 0
    assert "seq2seq eval:" in capsys.readouterr().out
    assert (tmp_path / "seq2seq" / "Seq2Seq_generated.pdb").exists()
    # and vae, which raised naming A13 until the generative line was ported
    assert tcli.main(["train", "vae", "--device", "cpu", "--data", data_glob, "--epochs", "1",
                      "--batch-size", "3", "--out-dir", str(tmp_path)]) == 0
    assert (tmp_path / "vae" / "VAE_generated.pdb").exists()
