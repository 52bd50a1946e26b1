"""Device time of the operations launched inside the key switch's spans,
as a share of the profiled window's device busy time."""

from fhebench.metrics import _trace


def read(run):
    return _trace.share_pct(run, "identity_key_switch")
