"""Device ms per batch of the operations launched inside the program's
`turbo.siso1` and `turbo.siso2` ranges."""

SISO = ("turbo.siso1", "turbo.siso2")


def read(run):
    tr = run.trace
    if tr is None or not tr.n_batches:
        return None
    us = tr.device_us(lambda rs: any(r in SISO for r in rs))
    return us / tr.n_batches / 1e3 if us > 0 else None
