"""The bit circuits' share of the device's busy time: the device time of
the operations launched inside the program's ``bootstrap`` spans over the
profiled sub-window's busy time.  In the radix cell every gate bootstrap
is bit-circuit work: ``lt``'s combine of the digits' (lt, eq) bits
(``ctx.or_``, ``ctx.and_``) and ``min_``'s select on bits (``ctx.mux``);
the digit lookups and the bit bridges (``to_bits``, ``from_bits``) run in
``pbs`` spans, which hold no ``bootstrap``."""

from fhebench.metrics import _program, _trace


def read(run):
    ops, _ = _program.ops_in(run, "bootstrap")
    busy = _trace.busy_s(run.trace) if run.trace is not None else 0.0
    if not ops or busy <= 0:
        return None
    return 100.0 * sum(e - s for s, e, _, _ in ops) / 1e6 / busy
