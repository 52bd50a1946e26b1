"""Set-up seconds, host clock: from the process's start (imports, keys
from the seed, the port's key preparation and kernel build or load, the
encrypted inputs) to the end of the warm-up."""


def read(run):
    return run.setup_s
