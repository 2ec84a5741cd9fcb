"""Every replica-step of the window over the window's wall seconds (host
clock, the window ending in a device synchronisation)."""


def read(run):
    return run.window_replica_steps / run.window_s
