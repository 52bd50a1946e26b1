"""The 95th percentile of request latency in ms, host clock, over every
request of the window."""

from fhebench.metrics import _latency


def read(run):
    return _latency.percentile_ms(run, 95)
