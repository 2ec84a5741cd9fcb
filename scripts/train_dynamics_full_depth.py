#!/usr/bin/env python3
"""Train the port's families at docs/TRAINING.md's depth.

Runs ``python -m molecular_dynamics_tpu_torch.cli train <family>`` in process
for each family of ``DEPTH`` (its ``--epochs``; the fine-tunes run their
default epochs after them; the recipe knobs of ``ENV`` set for the run) on
``datasets/backbone_smd`` (batch 32, seed 0 or each of ``--seeds``), and
prints one JSON line per run (wall seconds, eval.json's ``mean_abs_error``,
``rg_abs_error`` and ``std_abs_error``, and ``sde``'s marginal TV and its
floor) and, last, the device's name and ``nvidia-smi``'s name and power
limit. Runs on the CUDA device unless ``--device cpu`` is given.

    python3 scripts/train_dynamics_full_depth.py [--families hnn node] [--seeds 0 1]
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: ``--epochs`` of each family at docs/TRAINING.md's depth. That table's
#: epochs count the base epochs and the fine-tune's (the committed
#: runs_r3/<family>/train_log.csv end at epoch ``epochs + ft_epochs - 1``):
#: lstm 64 + 4, lstm-gat 2 + 8, transformer 16 + 4, seq2seq-graph 64 + 4;
#: lstm-nll, seq2seq and seq2seq-gan have no fine-tune. gat's committed log
#: (last epoch 5, 5,220 updates) fits no setting of today's knobs: it runs
#: the table's 6 epochs, then its default 6-epoch fine-tune.
DEPTH = {"hnn": 16, "hnn-schnet": 16, "hnn-latent": 32, "node": 32, "lstm": 64, "lstm-nll": 64,
         "seq2seq": 64, "seq2seq-gan": 16, "transformer": 16, "gat": 6, "lstm-gat": 2,
         "seq2seq-graph": 64, "flow": 64, "aae": 128, "vae": 64, "sde": 32, "pretrain": 16,
         "cgan": 16}
#: the non-default recipes behind docs/TRAINING.md's rows (its closing
#: notes): the flow's Fourier time features, the AAE's probe every 2 epochs
ENV = {"flow": {"MDX_FLOW_TEMB": "8"}, "aae": {"MDX_AAE_PROBE": "2"}}
#: eval.json's keys each line carries
KEYS = ("mean_abs_error", "rg_abs_error", "std_abs_error", "marginal_tv_mean",
        "marginal_tv_floor")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=str(ROOT / "runs" / "dynamics_full_depth"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--families", nargs="*", default=list(DEPTH))
    parser.add_argument("--seeds", nargs="*", type=int, default=[0])
    args = parser.parse_args(argv)

    import torch

    from molecular_dynamics_tpu_torch import cli

    data = str(ROOT / "datasets" / "backbone_smd" / "raw-traj_rep-*.npy")
    for seed in args.seeds:
        out_dir = pathlib.Path(args.out_dir) / f"seed{seed}"
        for family in args.families:
            env = ENV.get(family, {})
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                t0 = time.perf_counter()
                rc = cli.main(["train", family, "--data", data, "--epochs", str(DEPTH[family]),
                               "--batch-size", "32", "--seed", str(seed), "--out-dir",
                               str(out_dir), "--device", args.device])
                if args.device != "cpu":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k)
                    else:
                        os.environ[k] = v
            with open(out_dir / family / "eval.json") as fh:
                metrics = json.load(fh)
            print(json.dumps({"family": family, "epochs": DEPTH[family], "seed": seed, "rc": rc,
                              "env": env, "wall_seconds": wall,
                              **{k: metrics[k] for k in KEYS if k in metrics}}), flush=True)
    if args.device == "cpu":
        print(json.dumps({"device": "cpu"}))
    else:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
