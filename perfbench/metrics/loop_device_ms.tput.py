"""Device ms per batch of the operations launched inside the program's
`turbo.decode` range but outside its SISO ranges: stream packing, the
interleave gathers, the CRC syndrome and freezing, the outputs."""

SISO = ("turbo.siso1", "turbo.siso2")


def read(run):
    tr = run.trace
    if tr is None or not tr.n_batches:
        return None
    us = tr.device_us(lambda rs: "turbo.decode" in rs
                      and not any(r in SISO for r in rs))
    return us / tr.n_batches / 1e3 if us > 0 else None
