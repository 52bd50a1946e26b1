"""The median request latency in ms, host clock, over every request of the
window (the ``inclusive`` quantiles of ``statistics``)."""

from fhebench.metrics import _latency


def read(run):
    return _latency.percentile_ms(run, 50)
