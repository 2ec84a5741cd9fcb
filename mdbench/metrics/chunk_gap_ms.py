"""Device idle time at a chunk boundary: from the end of the last kernel one
chunk launched to the start of the first kernel of the next, averaged over
the boundaries of the traced stretch. It holds the copy of the frames and
log to the host, the next call's table build and its first launch."""


def read(run):
    gaps = run.trace.chunk_gaps if run.trace else []
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
