"""The control: a cell run with the reference, computed in float32, in the
program's place at the generator's probes (``checks.control``).  Its
numbers are the upper readings the limits are set against, and it has to
come out as not correct.  The benchmark's own runs never run it.

    python3 -m fhebench.control --workload <cell> --seeds 1,2,3 --seconds <s>

prints one JSON line per seed with the checked numbers.
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m fhebench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    import torch

    from fhebench import checks, harness

    if not torch.cuda.is_available():
        print("the control runs on the CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                               tamper=checks.control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "float32",
                          "correct": res["correct"], "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
