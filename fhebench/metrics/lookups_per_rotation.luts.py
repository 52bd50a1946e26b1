"""Table lookups a blind rotation over the window: the sum of ``rows`` x
``tables`` over the program's ``pbs`` spans over the sum of ``rows`` over
its ``blind_rotate`` spans.  One ``lut`` and one ``luts2`` request a block
read 1.5; it falls if ``apply_luts`` ever takes a rotation a table."""

from fhebench.metrics import _program


def read(run):
    recs = _program.records(run)
    lookups = sum(r.attrs["rows"] * r.attrs["tables"] for r in recs if r.name == "pbs")
    rotated = sum(r.attrs["rows"] for r in recs if r.name == "blind_rotate")
    if not lookups or not rotated:
        return None
    return lookups / rotated
