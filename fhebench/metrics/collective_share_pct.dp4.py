"""Rank 0's device time under the program's ``collective`` spans (the
all-gather of every bootstrap pass: the transfer and the wait for the
slowest card) as a share of the profiled sub-window's busy time."""

from fhebench.metrics import _program, _trace


def read(run):
    ops, _ = _program.ops_in(run, "collective")
    busy = _trace.busy_s(run.trace) if run.trace is not None else 0.0
    if not ops or busy <= 0:
        return None
    return 100.0 * sum(e - s for s, e, _, _ in ops) / 1e6 / busy
