"""The share of the one-shot spans (each batch's range, from its
submission to its result on the host) in which no operation ran on the
card, %."""


def read(run):
    tr = run.trace
    if tr is None or not tr.n_batches or not tr.in_batches():
        return None
    spans = tr.batch_spans()
    total = sum(hi - lo for lo, hi in spans)
    return 100.0 * (1.0 - tr.busy_us(spans) / total)
