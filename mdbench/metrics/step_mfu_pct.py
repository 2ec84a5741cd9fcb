"""The window's float32 operations (the step work of every replica-step and
one energy evaluation per replica and logged save, ``counts/``) over its
wall seconds, over the card's float32 peak, in per cent."""


def read(run):
    w = run.work
    flops = (run.window_replica_steps * w["step_flops"]
             + run.window_logged_saves * run.traffic["replicas"] * w["energy_flops"])
    return 100.0 * flops / run.window_s / run.peaks["float32_flops_per_s"]
