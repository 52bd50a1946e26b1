"""The port's own share of the set-up, in seconds: the time the program's
``setup.*`` spans cover (the kernel libraries' build or load, the engine
probe, the key preparation; nested ones counted once) from the set-up's
start to the window's."""

from fhebench.metrics import _program


def read(run):
    if not run.records:
        return None
    lo = run.start - run.setup_s
    spans = sorted((r.t0_ns / 1e9, r.t1_ns / 1e9) for r in _program.records(run, lo, run.start)
                   if r.name.startswith("setup."))
    total, end = 0.0, lo
    for s, e in spans:
        if e > end:
            total += e - max(s, end)
            end = e
    return total if spans else None
