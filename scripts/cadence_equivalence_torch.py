#!/usr/bin/env python3
"""Campaign-length equivalence of the LCPO cadence on the PyTorch/CUDA port.

Two GBIS + LCPO SMD campaigns of the port's data-generation twin
(``python -m molecular_dynamics_tpu_torch.regenerate_smd --gbis``), 64
replicas x 500,000 steps of 2 fs (1 ns) each, the same seeds and protocol,
the LCPO force every step (``--sasa-every 1``) and held for 5 steps
(``--sasa-every 5``), both through the campaign kernel, compared as the JAX
package's ``scripts/sasa_cadence_equivalence.py`` compares its two arms:

- the SMD work of every replica, W = fk sum_i (c_i - colvar_i) dc_i over
  the saves, its mean, spread and the z-score of the two means;
- each energy term's mean over the second half of the first ``--reps``
  replicas' frames (every ``--frame-stride``-th), with its z-score;
- the temperature over the second half, the radius of gyration, the final
  end-to-end distance and the colvar lag.

Each delta is held against the bounds of ``tests/test_sasa_cadence_equiv.py``
(work |delta| < 0.5 kcal/mol, z < 1.5, stds within 20 %; every energy term
within 1.0 kcal/mol, the LCPO term within 0.1; T within 2 K, Rg 0.1 A,
final e2e 0.5 A, lag 0.1 A); the script exits 1 where one fails.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/cadence_equivalence_torch.py --out docs/artifacts/sasa_k_equiv_torch.json

(about 5 minutes on an H100; ``--steps`` and ``--replicas`` cut it for a
trial, ``--device cpu`` runs the kernels' plain versions). The two campaigns
write into a temporary directory under ``--workdir`` (default: the system's
temporary directory), removed at the end.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from molecular_dynamics_tpu_torch import regenerate_smd  # noqa: E402
from molecular_dynamics_tpu_torch.energy import GBIS_CONFIG, energy_terms  # noqa: E402
from molecular_dynamics_tpu_torch.evaluate import radius_of_gyration  # noqa: E402
from molecular_dynamics_tpu_torch.examples import decaalanine_full  # noqa: E402

#: (quantity, the bound on |k5 - k1|) of tests/test_sasa_cadence_equiv.py
BOUNDS = {"work": 0.5, "work_z": 1.5, "energy_term": 1.0, "sasa": 0.1, "temperature": 2.0,
          "rg": 0.1, "e2e_final": 0.5, "colvar_lag": 0.1}


def run_arm(out, args, sasa_every):
    argv = ["--gbis", "--replicas", str(args.replicas), "--steps", str(args.steps),
            "--sasa-every", str(sasa_every), "--max-dump", str(args.reps), "--out", str(out),
            "--device", args.device]
    t0 = time.perf_counter()
    regenerate_smd.main(argv)
    return time.perf_counter() - t0


def pull_work(cv, center, fk):
    """W_r = fk sum_i (c_i - cv_ir) dc_i: the moving restraint's work."""
    dc = np.diff(center, prepend=center[0])
    return fk * ((center[:, None] - cv) * dc[:, None]).sum(axis=0)


def term_stats(out, ff, args, device):
    """Each energy term's mean and SEM over the second half of the dumped
    replicas' frames, every ``frame_stride``-th, and the radius of gyration."""
    frames = []
    for r in range(args.reps):
        fr = np.load(out / f"raw-traj_rep-{r}.npy")
        frames.append(fr[len(fr) // 2 :: args.frame_stride])
    batch = np.concatenate(frames).astype(np.float32)
    parts = []
    with torch.no_grad():
        for s in range(0, len(batch), 256):
            pos = torch.as_tensor(batch[s : s + 256], device=device)
            parts.append({k: v.double().cpu().numpy()
                          for k, v in energy_terms(pos, ff, config=GBIS_CONFIG).items()})
    stats = {}
    for k in parts[0]:
        vals = np.concatenate([p[k] for p in parts])
        stats[k] = {"mean": float(vals.mean()), "sem": float(vals.std() / np.sqrt(len(vals)))}
    rg = radius_of_gyration(batch, ff.masses.cpu().numpy())
    stats["_rg"] = {"mean": float(rg.mean()), "sem": float(rg.std() / np.sqrt(len(rg)))}
    return stats, len(batch)


def arm_summary(out, ff, args, device, seconds):
    summary = json.loads((out / "summary.json").read_text())
    log = np.load(out / "full_log.npz")
    cv, center = log["colvar_value"], log["colvar_center"][:, 0]
    work = pull_work(cv, center, args.fk)
    half = len(cv) // 2
    terms, n_frames = term_stats(out, ff, args, device)
    return {
        "replicas": int(cv.shape[1]), "seconds": seconds,
        "work_mean": float(work.mean()), "work_std": float(work.std()),
        "work_sem": float(work.std() / np.sqrt(len(work))),
        "colvar_lag_mean": float((center[half:, None] - cv[half:]).mean()),
        "energy_terms": terms, "energy_frames": n_frames, "summary": summary,
    }


def compare(a, b):
    def z(ma, sa, mb, sb):
        return abs(ma - mb) / max(np.hypot(sa, sb), 1e-12)

    def delta(key):
        return {"k1": a["summary"][key], "k5": b["summary"][key],
                "delta": b["summary"][key] - a["summary"][key]}

    c = {
        "work": {"k1_mean": a["work_mean"], "k5_mean": b["work_mean"],
                 "k1_std": a["work_std"], "k5_std": b["work_std"],
                 "delta": b["work_mean"] - a["work_mean"],
                 "z": float(z(a["work_mean"], a["work_sem"], b["work_mean"], b["work_sem"]))},
        "temperature": delta("temperature_mean_K"),
        "rg": delta("rg_mean_A"),
        "e2e_final": delta("e2e_final_mean_A"),
        "colvar_lag": {"k1": a["colvar_lag_mean"], "k5": b["colvar_lag_mean"],
                       "delta": b["colvar_lag_mean"] - a["colvar_lag_mean"]},
        "energy_terms": {},
    }
    for k in sorted(a["energy_terms"]):
        ta, tb = a["energy_terms"][k], b["energy_terms"][k]
        c["energy_terms"][k] = {"k1_mean": ta["mean"], "k5_mean": tb["mean"],
                                "delta": tb["mean"] - ta["mean"],
                                "z": float(z(ta["mean"], ta["sem"], tb["mean"], tb["sem"]))}
    w = c["work"]
    terms = {k: v for k, v in c["energy_terms"].items() if not k.startswith("_")}
    c["bounds"] = BOUNDS
    c["holds"] = {k: bool(v) for k, v in {
        "work": abs(w["delta"]) < BOUNDS["work"],
        "work_z": w["z"] < BOUNDS["work_z"],
        "work_std": abs(w["k1_std"] - w["k5_std"]) < 0.2 * w["k1_std"],
        "energy_terms": all(abs(t["delta"]) < BOUNDS["energy_term"] for t in terms.values()),
        "sasa": abs(terms["sasa"]["delta"]) < BOUNDS["sasa"],
        "temperature": abs(c["temperature"]["delta"]) < BOUNDS["temperature"],
        "rg": abs(c["rg"]["delta"]) < BOUNDS["rg"],
        "e2e_final": abs(c["e2e_final"]["delta"]) < BOUNDS["e2e_final"],
        "colvar_lag": abs(c["colvar_lag"]["delta"]) < BOUNDS["colvar_lag"],
    }.items()}
    return c


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=64)
    ap.add_argument("--steps", type=int, default=500_000)
    ap.add_argument("--reps", type=int, default=8, help="replicas whose frames feed the term means")
    ap.add_argument("--frame-stride", type=int, default=10)
    ap.add_argument("--fk", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    ff, _, _ = decaalanine_full(dtype=torch.float32, device=device)
    arms = {}
    with tempfile.TemporaryDirectory(dir=args.workdir) as tmp:
        for label, every in (("k1", 1), ("k5", 5)):
            out = pathlib.Path(tmp) / label
            seconds = run_arm(out, args, every)
            arms[label] = arm_summary(out, ff, args, device, seconds)
    comparison = compare(arms["k1"], arms["k5"])
    env = {"torch": torch.__version__, "device": args.device}
    if device.type == "cuda":
        env["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    result = {"env": env, "arms": arms, "comparison": comparison}

    c = comparison
    print(f"{'quantity':<18}{'k=1':>12}{'k=5':>12}{'delta':>10}{'z':>8}")
    print(f"{'SMD work':<18}{c['work']['k1_mean']:>12.3f}{c['work']['k5_mean']:>12.3f}"
          f"{c['work']['delta']:>10.3f}{c['work']['z']:>8.2f}")
    for k, v in c["energy_terms"].items():
        print(f"{'E ' + k:<18}{v['k1_mean']:>12.3f}{v['k5_mean']:>12.3f}"
              f"{v['delta']:>10.3f}{v['z']:>8.2f}")
    for k in ("temperature", "rg", "e2e_final", "colvar_lag"):
        v = c[k]
        print(f"{k:<18}{v['k1']:>12.3f}{v['k5']:>12.3f}{v['delta']:>10.3f}")
    print(json.dumps({"holds": c["holds"], "card": env.get("card")}))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {args.out}")
    return 0 if all(c["holds"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
