"""Padding rows' share of the circuit evaluator's bootstrap rows in the
window: the program's ``evaluate.level`` counts, 100 x the padding rows
((width - gates) x lanes) over all rows (width x lanes)."""

from fhebench.metrics import _program


def read(run):
    levels = [r for r in _program.records(run) if r.name == "evaluate.level"]
    rows = sum(r.attrs["rows"] for r in levels)
    if not rows:
        return None
    return 100.0 * sum(r.attrs["pad_rows"] for r in levels) / rows
