"""Decoded information bits of every batch completed in the window (B x K
a code-block batch, A a transport block), over the whole window on the host
clock; the batches run back to back and the window ends with a
synchronise.  Chained cells only."""


def read(run):
    if run.cell.traffic["loop"] != "chained" or run.window_s <= 0:
        return None
    return run.batches * run.cell.info_bits / run.window_s / 1e6
