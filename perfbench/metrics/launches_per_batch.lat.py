"""Device operations (kernels, copies, memsets) per batch in the trace,
every one a batch's range launched."""


def read(run):
    tr = run.trace
    if tr is None or not tr.n_batches:
        return None
    n = len(tr.in_batches())
    return n / tr.n_batches if n else None
