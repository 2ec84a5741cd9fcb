"""Device time of the kernels that PyTorch's libraries launch (the
observables, the frame copies within the device, the harness's finiteness
test) in the traced stretch, per save."""


def read(run):
    if not run.trace or not run.trace.aten_s:
        return None
    return 1e3 * run.trace.aten_s / run.traced_saves
