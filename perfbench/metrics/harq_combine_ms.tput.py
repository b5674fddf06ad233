"""Device ms per batch of the operations launched inside the program's
`harq.combine` range: the HARQ receiver's combine of a TTI's
transmissions into the soft buffers that stay on the card."""


def read(run):
    tr = run.trace
    if tr is None or not tr.n_batches:
        return None
    us = tr.device_us(lambda rs: "harq.combine" in rs)
    return us / tr.n_batches / 1e3 if us > 0 else None
