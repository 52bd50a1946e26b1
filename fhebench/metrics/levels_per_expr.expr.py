"""Bootstrap batches (levels) per expression over the window, from
the port's launch counters: one K3 launch, or n K1 steps, is one blind
rotation of one level."""


def read(run):
    if not run.records:
        return None
    n = run.params.n
    levels = run.launches["k3_rotations"] + (run.launches["k1_steps"]
                                             + run.launches["k1_panel_steps"]) / n
    return levels / len(run.records) if levels else None
