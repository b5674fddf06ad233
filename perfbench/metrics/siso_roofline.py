"""The SISO kernels' share of their roofline, %: the least time the card
could take for the SISO work of the traced batches (the larger of the
max-log BCJR's operations over the fp32 peak and its stream bytes over the
memory bandwidth, perfbench/harness/roofline.py, for each codeword's own
iterations from the outputs: the work its inputs needed), over the device
time of the operations launched inside the program's `turbo.siso1` and
`turbo.siso2` ranges."""

from perfbench.harness import roofline

SISO = ("turbo.siso1", "turbo.siso2")


def read(run):
    tr, pk = run.trace, run.peak()
    if tr is None or not tr.n_batches or pk is None:
        return None
    us = tr.device_us(lambda rs: any(r in SISO for r in rs))
    if us <= 0:
        return None
    need = sum(int(run.iters[b].sum()) for b in run.traced)
    ops, nbytes = roofline.siso_work(need, run.cell.K,
                                     run.cell.decoder_settings())
    return 100.0 * roofline.least_seconds(ops, nbytes, pk) / (us / 1e6)
