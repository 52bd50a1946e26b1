"""Device-idle milliseconds a level inside the key switch: the idle gaps of
the profiled sub-window whose middle lies in a program ``key_switch`` span
(the innermost span there), over the ``key_switch`` spans in it."""

from fhebench.metrics import _program


def read(run):
    n = len(_program.profiled(run, "key_switch"))
    idle = _program.idle_by_span(run)
    if not n or not idle:
        return None
    return 1e3 * idle.get("key_switch", 0.0) / n
