"""Bytes that cross cards at rank 0 per gate served: the ``bytes`` of the
program's ``collective`` spans in the window (a gather over g ranks moves
(g - 1) / g of its output to each) over the lanes of the window's
requests."""

from fhebench.metrics import _program


def read(run):
    colls = [r for r in _program.records(run) if r.name == "collective"]
    if not colls:
        return None
    return sum(r.attrs["bytes"] for r in colls) / run.units()
