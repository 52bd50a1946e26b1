"""The key switch's share of the device's busy time: the device time of
the operations launched inside the program's ``key_switch`` spans (16,384
lv1 rows after ``apply_lut``, 32,768 after ``apply_luts``) over the
profiled sub-window's busy time."""

from fhebench.metrics import _program, _trace


def read(run):
    ops, _ = _program.ops_in(run, "key_switch")
    busy = _trace.busy_s(run.trace) if run.trace is not None else 0.0
    if not ops or busy <= 0:
        return None
    return 100.0 * sum(e - s for s, e, _, _ in ops) / 1e6 / busy
