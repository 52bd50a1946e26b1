"""Device operations a level's bootstrap: the operations launched inside
the program's ``bootstrap`` spans in the profiled sub-window (kernels,
copies and sets), over those spans."""

from fhebench.metrics import _program


def read(run):
    ops, n = _program.ops_in(run, "bootstrap")
    if not ops:
        return None
    return len(ops) / n
