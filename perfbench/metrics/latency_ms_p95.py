"""The 95th percentile of the same population as latency_ms_p50 (Python's
`statistics.quantiles`, inclusive method).  One-shot cells only."""

import statistics


def read(run):
    if run.cell.traffic["loop"] != "oneshot" or len(run.latencies_ms) < 20:
        return None
    return statistics.quantiles(run.latencies_ms, n=20,
                                method="inclusive")[18]
