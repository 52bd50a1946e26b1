"""The blind rotation's share of its roofline in the profiled window: the
least time of the rotations run (``_roofline``: the Karatsuba int8 count
and the bytes, against the published H100 peaks) over the device time of
every operation launched inside their spans."""

from fhebench.metrics import _trace


def read(run):
    return _trace.rotate_roofline_pct(run)
