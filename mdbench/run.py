#!/usr/bin/env python3
"""Run one cell of the benchmark of ``molecular_dynamics_tpu_torch``.

    python3 mdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA GPU. Set-up builds
the cell's configuration and traffic (``mdbench/spec.py``), runs FIRE, sets
the SMD bias and runs one chunk as a warm-up; the window then runs chunks
(``simulate_ensemble`` calls with ``fused_campaign=True``, the state carried
over, frames and log copied to the host) until ``--seconds`` have passed.
With ``--trace 1`` a few whole chunks after the first are profiled and the
cell's per-layer metrics are reported instead of its end-to-end ones. Once
the window has closed the program's outputs on rows drawn from the seed are
compared with the plain reference (``mdbench/check.py``), and the campaign
kernel's launches in the window are counted: a run that fell back to the
program's composed path is not correct (its fallback warning is an error
here). The last line of standard output is the result; the last lines of
standard error give each number compared beside its limit.

``--device cpu`` rehearses a run on the CPU (the kernels' plain versions)
at a size ``--replicas`` and ``--chunk-steps`` may cut; it reports no
device metric.
"""

import time

_T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the checkout's root, not mdbench/, leads the path: the benchmark's module
# names must not shadow the standard library's
sys.path[0] = str(ROOT)
# every build and kernel cache of the run at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

#: the traced stretch: whole chunks of the window, from its second
TRACE_FIRST = 1
TRACE_CHUNKS = 4
PACKAGE = "molecular_dynamics_tpu_torch"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--replicas", type=int, help="rehearsal on the CPU only")
    ap.add_argument("--chunk-steps", type=int, help="rehearsal on the CPU only")
    args = ap.parse_args(argv)
    if args.device != "cpu" and (args.replicas or args.chunk_steps):
        ap.error("--replicas and --chunk-steps cut a CPU rehearsal only")
    return args


class Run:
    """What the metric readers read (``mdbench/metrics/``)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def _card(device) -> dict:
    import torch

    info = {"kind": torch.cuda.get_device_name(device)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.splitlines()
        info["nvidia_smi"] = out[0].strip() if out else ""
    except (OSError, subprocess.SubprocessError) as exc:
        info["nvidia_smi"] = f"unread: {exc}"
    return info


def main(argv=None) -> int:
    args = parse_args(argv)
    from mdbench import spec

    # the program warns and runs its composed path where the campaign kernel
    # does not cover an option: here that is a failed run, not a result
    warnings.filterwarnings("error", message="fused_campaign requested")
    cell = spec.cell(args.workload)
    import numpy as np
    import torch

    on_card = args.device == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"mdbench: {args.workload} needs {cell.chips} CUDA device(s), this machine has "
              f"{have}; nothing was measured", file=sys.stderr)
        return 2
    device = torch.device("cuda:0" if on_card else "cpu")
    traffic = dict(cell.traffic)
    for key, value in (("replicas", args.replicas), ("chunk_steps", args.chunk_steps)):
        if value:
            traffic[key] = value

    from torch.profiler import record_function

    from mdbench import campaign, check, tracing
    from mdbench.counts import work as counts
    from mdbench.reference.system import build_system, load_arrays

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    cfg = cell.config
    arrays = load_arrays(spec.HERE / "data" / cfg["system"])
    t_imported = time.perf_counter() - _T_PROCESS
    camp = campaign.Campaign(cfg, traffic, arrays, args.seed, device)
    sync()
    t_built = time.perf_counter() - _T_PROCESS
    rng = np.random.default_rng(args.seed)
    records = []
    tally = {"attempted": 0, "failed": 0}

    def run_chunk(k: int, plan: dict, state_in: dict) -> dict:
        """Chunk ``k`` (0 is the warm-up); returns the next chunk's plan and
        input rows, gathered outside the chunk's range."""
        with record_function(tracing.CHUNK_RANGE):
            out = camp.chunk()
        nxt = check.plan_chunk(rng, traffic)
        state_out = camp.state_rows(plan["rows"])
        next_in = camp.state_rows(nxt["rows"])
        records.append(check.keep(plan, k * traffic["chunk_steps"], state_in, state_out, out,
                                  traffic))
        if k:
            tally["attempted"] += traffic["replicas"]
            tally["failed"] += int((~out.finite).sum())
        return nxt, next_in

    plan = check.plan_chunk(rng, traffic)
    plan, state_in = run_chunk(0, plan, camp.state_rows(plan["rows"]))
    tracer = None
    if args.trace:
        tracer = tracing.Tracer(tracing.own_kernel_names(ROOT / PACKAGE))
        tracer.warm(lambda: (torch.ones(8, device=device) * 2.0).sum().item())
    sync()
    setup_s = time.perf_counter() - _T_PROCESS

    launches_before = camp.launches()
    t_window = time.perf_counter()
    stop_s = 0.0
    k = 1
    while True:
        if tracer and k == TRACE_FIRST:
            tracer.start()
        plan, state_in = run_chunk(k, plan, state_in)
        if tracer and k == TRACE_FIRST + TRACE_CHUNKS - 1:
            t_stop = time.perf_counter()
            tracer.stop()
            stop_s = time.perf_counter() - t_stop
        k += 1
        traced = not tracer or k >= TRACE_FIRST + TRACE_CHUNKS
        if time.perf_counter() - t_window >= args.seconds and traced:
            break
    sync()
    # the profiler's own stop is the trace's cost, not the program's
    window_s = time.perf_counter() - t_window - stop_s
    window_chunks = k - 1
    n_saves = traffic["chunk_steps"] // traffic["save_every"]
    launches = camp.launches() - launches_before
    # one launch a segment on the card; the CPU's plain version launches none
    launches_due = window_chunks * n_saves if on_card else 0
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else None
    card = _card(device) if on_card else {"kind": "cpu"}
    if tracer:
        tracer.read()

    camp.release()
    del camp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checked = check.select(records, rng)
    terms = cfg["energy"]["terms"]
    prog = check.outputs_program(checked, traffic, terms)
    ref = check.outputs_reference(checked, cfg, traffic, arrays, args.seed, device,
                                  torch.float64)
    readings = check.gaps(prog, ref, checked)
    check_s = time.perf_counter() - t_check
    limits = cell.limits
    correct = (check.judge(readings, limits) and tally["failed"] == 0
               and launches == launches_due)

    frames = np.concatenate([r["frames"].reshape(-1, *r["frames"].shape[-2:]) for r in records])
    work = counts.work(build_system(arrays, "cpu"), cfg, traffic, frames)
    n_logged = n_saves // traffic["obs_every"]
    run = Run(
        setup_s=setup_s, window_s=window_s, traffic=traffic, work=work,
        peaks=spec.load_json(spec.HERE / "counts" / "peaks.json"),
        window_replica_steps=window_chunks * traffic["chunk_steps"] * traffic["replicas"],
        window_logged_saves=window_chunks * n_logged,
        trace=tracer.trace if tracer else None,
        traced_saves=TRACE_CHUNKS * n_saves,
    )
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    from mdbench.guard import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"mdbench: the run loaded {found}; the benchmark measures {PACKAGE} alone",
              file=sys.stderr)
        return 3

    print(f"mdbench: {args.workload} seed {args.seed}: set-up {setup_s:.3f} s (imports "
          f"{t_imported:.3f}, system, FIRE, bias and replicas {t_built - t_imported:.3f}, "
          f"warm-up chunk {setup_s - t_built:.3f}), window "
          f"{window_s:.3f} s, {window_chunks} chunks, {len(checked)} checked in {check_s:.3f} s, "
          f"campaign kernel launches {launches}, device peak "
          f"{memory_peak} B, {card['kind']}", file=sys.stderr)
    # a number that is not finite is written as text: the line stays JSON
    shown = {k: v if math.isfinite(v) else repr(v) for k, v in readings.items()}
    checks = {name: {"value": shown[name], "limit": limits[name]} for name in check.NUMBERS}
    checks["failed_replicas"] = {"value": tally["failed"], "limit": 0}
    checks["campaign_launches"] = {"value": launches, "limit": launches_due}
    result = {"correct": bool(correct), **tally}
    if on_card:
        result["metrics"] = metrics
        result["device"] = {"platform": "gpu", "kind": card["kind"], "count": cell.chips,
                            "memory_peak_bytes": memory_peak, "nvidia_smi": card["nvidia_smi"]}
        if tracer:
            result["device"].update(busy_s=tracer.trace.busy_s, window_s=tracer.trace.window_s)
            result["breakdown"] = tracer.trace.breakdown
    else:
        # a CPU rehearsal measures no device: its numbers stay apart
        result["metrics"] = {m["name"]: {"value": None, "unit": m["unit"]} for m in
                             (cell.per_layer if args.trace else cell.end_to_end)}
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": None}
        result["rehearsal_on_cpu"] = metrics
    result["check"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
