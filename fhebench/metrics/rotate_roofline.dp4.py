"""Rank 0's blind rotations' share of their roofline in the profiled
sub-window: the least time of the program's ``blind_rotate`` spans by
their ``rows`` and ``tv_rows`` (``_roofline``, the count
``rotate_roofline.gates`` uses) over the device time of the operations
launched inside them."""

from fhebench.metrics import _program, _roofline


def read(run):
    spans = _program.profiled(run, "blind_rotate")
    ops, _ = _program.ops_in(run, "blind_rotate")
    device_s = sum(e - s for s, e, _, _ in ops) / 1e6
    if not spans or device_s <= 0:
        return None
    least = sum(_roofline.rotation_least_s(run.params, r.attrs["rows"], r.attrs["tv_rows"])
                for _, _, r in spans)
    return 100.0 * least / device_s
