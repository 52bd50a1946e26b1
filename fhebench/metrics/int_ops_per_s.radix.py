"""Integer ops completed per second, host clock: every lane of every
operator request in the window, over the time from the window's start to
its last completion."""


def read(run):
    return run.units() / (run.end - run.start)
