"""The median, over every batch of the window, of the host-clock time from
a batch's submission to its hard bits, iteration counts and verdicts on
the host; each batch is submitted once the last one's result is there.
One-shot cells only."""

import statistics


def read(run):
    if run.cell.traffic["loop"] != "oneshot" or not run.latencies_ms:
        return None
    return statistics.median(run.latencies_ms)
