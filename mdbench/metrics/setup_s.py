"""Seconds from the start of the process to the start of the window: the
imports, the build or load of the kernels, the system, FIRE, the bias, the
start forces, the replicas and the warm-up chunk (host clock)."""


def read(run):
    return run.setup_s
