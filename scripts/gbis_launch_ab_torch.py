#!/usr/bin/env python3
"""Time the campaign kernel's GBIS launches of two checkouts in turns.

    python3 scripts/gbis_launch_ab_torch.py --other PATH [--out FILE]

PATH is another checkout's root (or any directory holding its
``molecular_dynamics_tpu_torch`` package, e.g. unpacked from another commit
by ``git archive``). Both checkouts first build their kernels at once; then
each runs in a process of its own, in the order other, this, this, other:
the campaign kernel under ``GBIS_CONFIG`` (rigid X-H bonds, ``sasa_every``
1, 300 K, 50 steps a launch, no bias) at 104 atoms x 1024 replicas and 416
x 192 (``tiled_decaalanine``), from the packaged coordinates jittered by
0.02 A, at rest, with zero carried forces; three windows of 10 launches
each, timed with CUDA events after one warm-up launch. Where a checkout has
``fused_step.campaign_sasa_lists_global``, the 416-atom launch is timed
also with the LCPO lists in the global workspace. Prints one JSON line a
run, the card's name and power limit, and writes the runs to FILE. Needs
one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZES = ((1, 1024), (4, 192))
WINDOWS, LAUNCHES = 3, 10
BUILD = "from molecular_dynamics_tpu_torch.ops import _build; _build.build_all()"


def run_child(tag: str) -> dict:
    """Time this process's package (the one on PYTHONPATH)."""
    import torch

    from molecular_dynamics_tpu_torch.constraints import hydrogen_bond_constraints
    from molecular_dynamics_tpu_torch.energy import GBIS_CONFIG
    from molecular_dynamics_tpu_torch.examples import decaalanine_full, tiled_decaalanine
    from molecular_dynamics_tpu_torch.ops import fused_step

    def make(ff):
        e = GBIS_CONFIG
        return fused_step.make_fused_campaign_op(
            ff, n_inner=50, dt_fs=2.0, temperature=300.0, gamma_ps=1.0, cutoff=e.cutoff,
            switch_dist=e.switch_dist, rfa=e.rfa, solvent_dielectric=e.solvent_dielectric,
            ion_concentration=e.ion_concentration, surface_tension=e.surface_tension,
            constraints=hydrogen_bond_constraints(ff), gb=True, sasa=True)

    def window_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(LAUNCHES):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / LAUNCHES

    out = {"tree": tag}
    rule = getattr(fused_step, "campaign_sasa_lists_global", None)
    for m, n_rep in SIZES:
        ff, coords, _ = decaalanine_full() if m == 1 else tiled_decaalanine(m)
        gen = torch.Generator().manual_seed(7)
        pos = (torch.as_tensor(coords, dtype=torch.float32)[None] + 0.02 * torch.randn(
            (n_rep,) + tuple(coords.shape), generator=gen)).cuda().contiguous()
        zeros = torch.zeros_like(pos)
        variants = [("as_built", rule)]
        if m == 4 and rule is not None:
            variants.append(("lists_global", lambda *sizes: True))
        for label, chosen in variants:
            if chosen is not None:
                fused_step.campaign_sasa_lists_global = chosen
            op = make(ff)
            out[f"{ff.n_atoms}x{n_rep}:{label}"] = {
                "ms": [window_ms(lambda: op(pos, zeros, zeros, 0, 3)) for _ in range(WINDOWS)],
                **op.kernel_info()}
        if rule is not None:
            fused_step.campaign_sasa_lists_global = rule
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=pathlib.Path, required=True)
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(run_child(args.child)), flush=True)
        return 0
    trees = {"this": ROOT, "other": args.other.resolve()}
    env = {tag: dict(os.environ, PYTHONPATH=str(tree)) for tag, tree in trees.items()}
    builds = {tag: subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree, env=env[tag])
              for tag, tree in trees.items()}
    if any(proc.wait() for proc in builds.values()):
        print("a build failed", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    runs = []
    for tag in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, __file__, "--other", str(args.other), "--child", tag],
                              cwd=trees[tag], env=env[tag], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(smi, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"nvidia_smi": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
