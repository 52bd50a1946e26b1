"""PBS rows per integer op over the window: the rows of every ``pbs.pbs``
and ``pbs.pbs_many`` call (the benchmark's spans; a ``pbs_many`` row is one
rotation for all its tables) over the ops completed."""


def read(run):
    if not run.spans or not run.records:
        return None
    rows = sum(run.spans.layers[k].rows for k in ("pbs", "pbs_many") if k in run.spans.layers)
    return rows / run.units() if rows else None
