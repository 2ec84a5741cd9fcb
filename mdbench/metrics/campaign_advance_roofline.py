"""The least time the traced saves' step work needs on the card (the larger
of its float32 operations over the float32 peak and its bytes over the
memory bandwidth, ``counts/``) over the device time of the program's own
kernels, in per cent."""

from mdbench.counts.work import least_seconds


def read(run):
    if not run.trace or not run.trace.own_s:
        return None
    w = run.work
    steps = run.traced_saves * run.traffic["save_every"] * run.traffic["replicas"]
    least = least_seconds(steps * w["step_flops"], run.traced_saves * w["launch_bytes"],
                          run.peaks)
    return 100.0 * least / run.trace.own_s
