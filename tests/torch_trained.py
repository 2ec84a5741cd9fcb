"""The trained generation maps of ``gat``, ``hnn-schnet`` and
``seq2seq-graph`` in the port, from the JAX package's trained weights, for
``test_torch_trained_generation.py`` and for ``chip_smoke.py`` (which loads
this file by path).

torch and the port only: no import of JAX, so the same map runs in the
parity test on the CPU and in the smoke run on the card. The weights
(``runs_r3/<family>/best.ckpt`` carried through ``convert``), the decoder
draws of ``seq2seq-graph``'s rollout (the JAX driver's key splits) and the
JAX package's eval.json on the CPU are kept in ``GOLDENS``;
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_trained_generation.py``
writes them anew.

Each map is the family's driver at ``epochs=0``: no update, no fine-tune
(the knobs of ``FAMILIES``), the rollouts and the evaluator as a trained run takes them, from
the first trajectories of ``datasets/backbone_smd`` (``DATA``: fewer starts
than a full run's, at the full rollout length).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import pathlib
from unittest import mock

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "goldens" / "trained_generation"
#: the JAX package's eval.json of each map on the CPU, by family
GOLDEN_EVAL = GOLDENS / "eval.json"
#: two trajectories of 320 frames: two rollout starts of each family
DATA = str(ROOT / "datasets" / "backbone_smd" / "raw-traj_rep-[01].npy")
#: eval.json keys agree within this many Angstrom (float32)
TOL = 2e-3
#: family -> (the port module of its model, the model's class, the knobs
#: that keep the driver from training)
FAMILIES = {
    "gat": ("gat", "GATSimulator", {"MDX_GAT_FT_EPOCHS": "0"}),
    "hnn-schnet": ("schnet", "SchNetHNN", {}),
    "seq2seq-graph": ("gat", "GraphSeq2Seq", {"MDX_GSEQ_FT_EPOCHS": "0"}),
}


def golden(family: str) -> dict:
    """``{"state_dict": ..., "noise": tensor or None}`` of ``family``, on the CPU."""
    return torch.load(GOLDENS / f"{family}.pt", map_location="cpu")


def golden_eval() -> dict:
    return json.loads(GOLDEN_EVAL.read_text())


def port_generation(family: str, out_dir, device, state_dict, noise=None) -> dict:
    """Run the port's ``family`` driver at ``epochs=0`` on ``device``, its
    model built with ``state_dict`` and (``seq2seq-graph``) its rollout
    driven by ``noise (segments, starts, decode, N, 5)``; returns the
    eval.json it writes."""
    from molecular_dynamics_tpu_torch.train import drivers
    from molecular_dynamics_tpu_torch.train import seq as train_seq

    module_name, cls_name, env = FAMILIES[family]
    module = importlib.import_module(f"molecular_dynamics_tpu_torch.models.{module_name}")
    cls = getattr(module, cls_name)

    def built(*args, **kw):
        obj = cls(*args, **kw)
        obj.load_state_dict(state_dict)
        return obj

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(module, cls_name, built))
        stack.enter_context(mock.patch.dict(os.environ, env))
        if noise is not None:
            rollout = train_seq.graph_chained_decode_rollout

            def replayed(model, windows, decode_len, n_steps, generator=None, refeature=None):
                return rollout(model, windows, decode_len, n_steps,
                               noise=noise.to(device=windows.device, dtype=windows.dtype),
                               refeature=refeature)

            stack.enter_context(mock.patch.object(train_seq, "graph_chained_decode_rollout",
                                                  replayed))
        rc = drivers.run_training(family=family, data=DATA, epochs=0, batch_size=32,
                                  out_dir=str(out_dir), seed=0, device=device)
    if rc != 0:
        raise RuntimeError(f"{family}: run_training returned {rc}")
    return json.loads((pathlib.Path(out_dir) / family / "eval.json").read_text())
