"""The share of the traced stretch of back-to-back batches, from the first
batch's start to the last device operation's end, in which no operation ran
on the card, %."""


def read(run):
    tr = run.trace
    if tr is None or not tr.n_batches or not tr.in_batches():
        return None
    lo, hi = tr.window()
    return 100.0 * (1.0 - tr.busy_us([(lo, hi)]) / (hi - lo))
