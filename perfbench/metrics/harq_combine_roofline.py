"""The HARQ combine's share of its roofline, %: the least time the card
could take to move the combine's bytes of the traced batches at its memory
bandwidth, over the device time of the operations launched inside the
program's `harq.combine` range.

The bytes are counted from the schedule (the cell's `pool_schedule`, what
each slot of each pool batch carries), whatever implements the combine: a
code block row of new data reads its E received LLRs and writes its whole
soft buffer, 4 E + 4 (3 K + 12) bytes in fp32; a retransmitted row reads
its E LLRs and reads and writes each distinct position its redundancy
version selects, 4 E + 8 d.  A cell without a schedule reads nothing."""

import functools

import numpy as np

from perfbench.harness import spec


@functools.lru_cache(maxsize=None)
def _distinct(K: int, E: int, rv: int, F: int) -> int:
    return len(np.unique(spec.selection(K, E, rv, F)))


def combine_bytes(layout, rv, new) -> float:
    """Bytes of one TTI's combine: `layout` the blocks' (K, E, F), rv and
    new each slot's redundancy version and new-data flag."""
    rv, new = np.asarray(rv), np.asarray(new, dtype=bool)
    total = 0
    for K, E, F in layout:
        fresh = int(new.sum())
        total += 4 * E * len(new) + 4 * (3 * K + 12) * fresh
        total += sum(8 * _distinct(K, E, int(v), F) for v in rv[~new])
    return float(total)


def read(run):
    tr, pk = run.trace, run.peak()
    sch = getattr(run.cell, "pool_schedule", None)
    if tr is None or not tr.n_batches or pk is None or sch is None:
        return None
    us = tr.device_us(lambda rs: "harq.combine" in rs)
    if us <= 0:
        return None
    order = np.asarray(run.cell.rv_order)
    layout = run.cell.layout()[1]
    P = len(sch["k"])
    nbytes = sum(combine_bytes(layout, order[sch["k"][i % P]],
                               sch["k"][i % P] == 0) for i in run.traced)
    return 100.0 * nbytes / pk["hbm_bytes_per_s"] / (us / 1e6)
