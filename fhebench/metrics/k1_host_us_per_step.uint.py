"""Host microseconds a K1 step: the program's ``blind_rotate`` spans on
the K1 loop (``path == "k1"``) in the window, their summed durations over
their summed step calls.  The loop launches asynchronously, so where the
device keeps up this is the host's cost of a step."""

from fhebench.metrics import _program


def read(run):
    rots = [r for r in _program.records(run)
            if r.name == "blind_rotate" and r.attrs.get("path") == "k1"]
    steps = sum(r.attrs["steps"] for r in rots)
    if not steps:
        return None
    return sum(r.t1_ns - r.t0_ns for r in rots) / 1e3 / steps
