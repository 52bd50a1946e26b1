"""Gates completed per second, host clock: every lane of every gate request
in the window (a MUX counts as one gate), over the time from the window's
start to its last completion."""


def read(run):
    return run.units() / (run.end - run.start)
