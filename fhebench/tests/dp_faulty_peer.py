"""A peer of ``traffic/gates_dp.py`` with a fault planted in its block: on
rank 1 the first output row of every bootstrap is negated where it is
produced, which flips the bit it carries.  The CPU tests start it in the
place of the real peer module."""

import json
import sys

from fhebench.traffic import gates_dp
from rustfhe_tpu_torch.parallel import sharded


def main(spec: dict) -> None:
    if spec["rank"] == 1:
        honest = sharded._bootstrap_local

        def altered(*args, **kwargs):
            out = honest(*args, **kwargs).clone()
            out.reshape(-1, out.shape[-1])[0] *= -1
            return out

        sharded._bootstrap_local = altered
    gates_dp.peer(spec)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
