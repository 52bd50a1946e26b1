"""The share of the profiled window in which no operation ran on the
device."""

from fhebench.metrics import _trace


def read(run):
    return _trace.idle_pct(run)
