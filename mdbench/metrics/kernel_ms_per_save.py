"""Device time of the program's own kernels (the ``__global__`` functions of
its CUDA sources, its Triton functions) in the traced stretch, per save."""


def read(run):
    if not run.trace or not run.trace.own_s:
        return None
    return 1e3 * run.trace.own_s / run.traced_saves
