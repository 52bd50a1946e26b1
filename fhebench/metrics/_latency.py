"""Request latencies of the window, host clock."""

import statistics


def percentile_ms(run, q: int):
    lat = [(r.t1 - r.t0) * 1e3 for r in run.records]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[q - 1]
