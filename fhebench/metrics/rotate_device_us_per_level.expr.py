"""Device microseconds of a K3 rotation: the device time of every operation
launched inside the program's ``blind_rotate`` spans on K3
(``path == "k3"``) in the profiled sub-window, over those spans."""

from fhebench.metrics import _program


def read(run):
    ops, n = _program.ops_in(run, "blind_rotate", lambda r: r.attrs.get("path") == "k3")
    if not ops:
        return None
    return sum(e - s for s, e, _, _ in ops) / n
