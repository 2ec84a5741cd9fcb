"""The share of the traced stretch in which no kernel runs (the union of
kernel intervals), in per cent."""


def read(run):
    if not run.trace or not run.trace.window_s or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
