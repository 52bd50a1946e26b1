"""Host milliseconds of the circuit evaluator's plan an expression: the
program's ``evaluate.plan`` spans in the window (``optimize``,
``_level_plan`` and the plan's uploads), summed, over the requests."""

from fhebench.metrics import _program


def read(run):
    plans = [r for r in _program.records(run) if r.name == "evaluate.plan"]
    if not plans:
        return None
    return sum(r.t1_ns - r.t0_ns for r in plans) / 1e6 / len(run.records)
