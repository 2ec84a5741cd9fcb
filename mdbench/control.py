#!/usr/bin/env python3
"""The readings a cell's limits are set from.

    python3 mdbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's set-up, its warm-up chunk and ``--chunks`` more
chunks at the cell's own load, then the comparison of ``mdbench/check.py``
on as many rows as a run of ``run_seconds`` compares, or more (``--rows``
a chunk): once with the program's outputs (the lower reading) and, for the
first ``--control-seeds`` seeds, with the reference itself in the program's
place, computed in the configuration's ``control_precision`` (the control)
and in float64 with each of ``check.FAULTS`` planted that the configuration
has a layer for. One JSON line a seed, then one with each number's largest
program reading, its smallest control and fault readings, and the limit
they give (``limit_from``). The benchmark's own runs do not run this.
"""

import argparse
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

#: numbers whose limit a planted fault may set: the medians. The widest gaps
#: read the rare rows at a cutoff's edge, a heavy tail, and keep the
#: control's limit
FAULT_BOUND = ("pos_gap_med_A", "pos_gap2_med_A", "force_gap_med", "log_gap_med")
#: a fault sets a number's upper reading where it reads this many times the lower
FAULT_FACTOR = 10.0


def readings_for_seed(cell, seed: int, chunks: int, rows: int, extra: bool, device) -> dict:
    """The readings of one seed; with ``extra`` the control's and the faults'."""
    import numpy as np
    import torch

    from mdbench import campaign, check, spec
    from mdbench.reference.system import load_arrays

    cfg, traffic = cell.config, cell.traffic
    arrays = load_arrays(spec.HERE / "data" / cfg["system"])
    camp = campaign.Campaign(cfg, traffic, arrays, seed, device)
    rng = np.random.default_rng(seed)
    records = []
    for k in range(chunks + 1):
        plan = check.plan_chunk(rng, traffic, rows)
        state_in = camp.state_rows(plan["rows"])
        out = camp.chunk()
        records.append(check.keep(plan, k * traffic["chunk_steps"], state_in,
                                  camp.state_rows(plan["rows"]), out, traffic))
    camp.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    terms = cfg["energy"]["terms"]

    def reference(dtype, fault=None):
        return check.outputs_reference(records, cfg, traffic, arrays, seed, device, dtype, fault)

    ref = reference(torch.float64)
    out = {"seed": seed, "rows": sum(len(r["rows"]) for r in records),
           "program": check.gaps(check.outputs_program(records, traffic, terms), ref, records)}
    if extra:
        out["control"] = check.gaps(reference(check.DTYPES[cfg["control_precision"]]), ref,
                                    records)
        out["faults"] = {name: check.gaps(reference(torch.float64, name), ref, records)
                         for name in check.faults_for(cfg)}
    return out


def limit_from(lower: float, upper: float) -> float:
    """0.6 of the way from the lower reading up to the upper in log space,
    rounded down to two significant digits: more room above the lower."""
    x = math.exp(0.4 * math.log(lower) + 0.6 * math.log(upper))
    unit = 10.0 ** (math.floor(math.log10(x)) - 1)
    return float(f"{math.floor(x / unit) * unit:.2g}")


def summary(workload: str, results: list) -> dict:
    """Each number's largest program reading, smallest control reading,
    smallest reading of each fault, the upper reading and the limit."""
    from mdbench import check

    out = {}
    for k in check.NUMBERS:
        lower = max(r["program"][k] for r in results)
        control = min(r["control"][k] for r in results if "control" in r)
        faults = {}
        for r in results:
            for name, g in r.get("faults", {}).items():
                faults[name] = min(faults.get(name, math.inf), g[k])
        upper, by = control, "control"
        if k in FAULT_BOUND:
            for name, v in faults.items():
                if FAULT_FACTOR * lower <= v < upper:
                    upper, by = v, name
        ok = lower > 0.0 and upper >= 3.0 * lower
        out[k] = {"lower": lower, "control": control, "faults": faults, "upper": upper,
                  "upper_by": by, "limit": limit_from(lower, upper) if ok else None}
    return {"workload": workload, "seeds": len(results), "numbers": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--rows", type=int, default=64)
    args = ap.parse_args(argv)
    import torch

    from mdbench import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("mdbench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    results = []
    for i, seed in enumerate(args.seeds):
        results.append(readings_for_seed(cell, seed, args.chunks, args.rows,
                                         i < args.control_seeds, device))
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps(summary(args.workload, results)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
