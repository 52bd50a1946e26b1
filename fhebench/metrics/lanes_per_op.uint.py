"""Bootstrap lanes per integer op over the window, padding lanes counted:
the rows of every ``TFHE.bootstrap_raw`` call (the benchmark's spans) over
the ops completed."""


def read(run):
    layer = run.spans.layers.get("bootstrap_raw") if run.spans else None
    if layer is None or not run.records:
        return None
    return layer.rows / run.units()
