#!/usr/bin/env python3
"""Train the families of either package at docs/TRAINING.md's depth.

Runs ``python -m <package>.cli train <family>`` in a subprocess for each
family of ``DEPTH`` (its ``--epochs``; the fine-tunes run their default epochs
after them; the recipe knobs of ``ENV`` set for the run) on
``datasets/backbone_smd`` (batch 32, seed 0 or each of ``--seeds``), ``--jobs``
runs side by side. ``--package torch`` (the default) runs the PyTorch port on
the CUDA device unless ``--device cpu`` is given; ``--package jax`` runs the
JAX package with ``JAX_PLATFORMS=cpu``. Prints one JSON line per run (wall
seconds, eval.json's ``mean_abs_error``, ``rg_abs_error`` and
``std_abs_error``, and ``sde``'s marginal TV and its floor) and, last, the
device; and writes each run's row (package, device, family, seed, wall
seconds, the three errors; card rows with ``nvidia-smi``'s name and power
limit) into ``--artifact``, replacing a row of the same package, device,
family and seed. ``--merge FILE`` only merges another artifact's
rows into ``--artifact``. ``--verdict`` only reads ``--artifact`` and prints,
for each family, the exact two-sided Mann-Whitney U test of the port's
card rows against the JAX package's CPU rows on ``mean_abs_error``
and on ``rg_abs_error``: a port fault where either p < 0.025, "not settled"
under 5 seeds a side.

    python3 scripts/train_dynamics_full_depth.py --families gat --seeds 0 1 2 3 4
    python3 scripts/train_dynamics_full_depth.py --package jax --families gat --jobs 5 --seeds 0 1 2 3 4
"""

import argparse
import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

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
PACKAGES = {"torch": "molecular_dynamics_tpu_torch", "jax": "molecular_dynamics_tpu"}
ARTIFACT = ROOT / "docs" / "artifacts" / "full_depth_spread.json"
#: what makes two rows the same run
ROW_KEY = ("package", "device", "family", "seed")
#: the verdict's metrics, its level on each (0.05 split over the two) and
#: the seeds a side it needs
VERDICT_KEYS, VERDICT_P, VERDICT_SEEDS = ("mean_abs_error", "rg_abs_error"), 0.025, 5


def merge_rows(path: pathlib.Path, rows: list) -> None:
    """Write ``rows`` into the artifact at ``path``, replacing rows of the same ``ROW_KEY``."""
    doc = json.loads(path.read_text()) if path.exists() else {"rows": []}
    new = {tuple(r.get(k) for k in ROW_KEY) for r in rows}
    kept = [r for r in doc["rows"] if tuple(r.get(k) for k in ROW_KEY) not in new]
    doc["rows"] = sorted(kept + rows, key=lambda r: tuple(str(r.get(k)) for k in ROW_KEY))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1) + "\n")


def verdicts(path: pathlib.Path) -> dict:
    """For each family with rows of both packages: each side's values of
    ``VERDICT_KEYS`` by seed, each key's exact two-sided Mann-Whitney p,
    and the verdict."""
    from scipy.stats import mannwhitneyu

    rows = json.loads(path.read_text())["rows"]

    def p_values(a, b):
        return {k: float(mannwhitneyu(a[k], b[k], alternative="two-sided",
                                      method="exact").pvalue) for k in VERDICT_KEYS}

    out = {}
    for family in sorted({r["family"] for r in rows}):
        sides = {name: sorted((r for r in rows if r["family"] == family
                               and (r["package"], r["device"]) == where), key=lambda r: r["seed"])
                 for name, where in (("port", ("torch", "cuda")), ("jax", ("jax", "cpu")),
                                     ("port_cpu", ("torch", "cpu")))}
        if not (sides["port"] and sides["jax"]):
            continue
        res = {name: {"seeds": [r["seed"] for r in side],
                      **{k: [r[k] for r in side] for k in VERDICT_KEYS}}
               for name, side in sides.items() if side}
        res["p"] = p_values(res["port"], res["jax"])
        if "port_cpu" in res:  # the port on the CPU, beside the verdict
            res["p_port_cpu"] = p_values(res["port_cpu"], res["jax"])
        if min(len(sides["port"]), len(sides["jax"])) < VERDICT_SEEDS:
            res["verdict"] = "not settled"
        elif min(res["p"].values()) < VERDICT_P:
            res["verdict"] = "port fault"
        else:
            res["verdict"] = "inside JAX's spread"
        out[family] = res
    return out


def run_one(args, family: str, seed: int, device: str) -> dict:
    out_dir = pathlib.Path(args.out_dir) / f"seed{seed}"
    env = dict(os.environ, **ENV.get(family, {}))
    if args.threads:
        env["OMP_NUM_THREADS"] = str(args.threads)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
                            f" intra_op_parallelism_threads={args.threads}").strip()
    cmd = [sys.executable, "-m", f"{PACKAGES[args.package]}.cli", "train", family, "--data",
           str(ROOT / "datasets" / "backbone_smd" / "raw-traj_rep-*.npy"), "--epochs",
           str(DEPTH[family]), "--batch-size", "32", "--seed", str(seed), "--out-dir",
           str(out_dir)]
    if args.package == "jax":
        env["JAX_PLATFORMS"] = "cpu"
        env.setdefault("MDX_COMPILE_CACHE", str(pathlib.Path(args.out_dir) / ".jax_cache"))
    else:
        cmd += ["--device", device]
    log = out_dir / f"{family}.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT).returncode
    wall = time.perf_counter() - t0
    metrics = {}
    if rc == 0:
        with open(out_dir / family / "eval.json") as fh:
            metrics = json.load(fh)
    return {"package": args.package, "device": device, "family": family, "seed": seed,
            "epochs": DEPTH[family], "env": ENV.get(family, {}), "rc": rc,
            "wall_seconds": wall, **{k: metrics[k] for k in KEYS if k in metrics}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0].replace("\n", " "),
        epilog="examples:\n" + "\n".join(__doc__.rstrip().splitlines()[-2:]),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--package", choices=sorted(PACKAGES), default="torch",
                        help="torch: the PyTorch port; jax: the JAX package, on the CPU")
    parser.add_argument("--out-dir", default=None,
                        help="default runs/dynamics_full_depth (torch) or "
                        "runs/dynamics_full_depth_jax (jax)")
    parser.add_argument("--device", default="cuda", help="the port's device (torch only)")
    parser.add_argument("--families", nargs="*", default=list(DEPTH))
    parser.add_argument("--seeds", nargs="*", type=int, default=[0])
    parser.add_argument("--jobs", type=int, default=1, help="runs side by side")
    parser.add_argument("--threads", type=int, default=0,
                        help="CPU threads of each run (0: the library's default)")
    parser.add_argument("--artifact", default=str(ARTIFACT))
    parser.add_argument("--merge", default=None,
                        help="merge this artifact's rows into --artifact and train nothing")
    parser.add_argument("--verdict", action="store_true",
                        help="print each family's verdict from --artifact and train nothing")
    args = parser.parse_args(argv)
    artifact = pathlib.Path(args.artifact)
    if args.verdict:
        for family, res in verdicts(artifact).items():
            print(json.dumps({"family": family, **res}))
        return 0
    if args.merge:
        merge_rows(artifact, json.loads(pathlib.Path(args.merge).read_text())["rows"])
        return 0
    if args.out_dir is None:
        args.out_dir = str(ROOT / "runs" / ("dynamics_full_depth" + ("_jax" if args.package == "jax"
                                                                     else "")))
    device = "cpu" if args.package == "jax" else args.device
    smi = None
    if device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    runs = [(family, seed) for family in args.families for seed in args.seeds]
    rows = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=args.jobs) as pool:
        futures = [pool.submit(run_one, args, family, seed, device) for family, seed in runs]
        for future in concurrent.futures.as_completed(futures):
            row = future.result()
            if smi is not None:
                row["nvidia_smi"] = smi
            print(json.dumps(row), flush=True)
            if row["rc"] == 0:
                rows.append(row)
                merge_rows(artifact, [row])
    print(json.dumps({"package": args.package, "device": device, "nvidia_smi": smi}))
    return 0 if len(rows) == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
