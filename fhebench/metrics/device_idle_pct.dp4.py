"""The share of the profiled sub-window in which no operation ran on rank
0's card (importing ``_program`` turns the program's tracer on, as for the
cell's other readers)."""

from fhebench.metrics import _program, _trace  # noqa: F401


def read(run):
    return _trace.idle_pct(run)
