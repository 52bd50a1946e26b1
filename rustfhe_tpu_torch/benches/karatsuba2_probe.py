"""The limb-outer two-level Karatsuba step against K1, on the card (P1).

Counterpart of ``benches/karatsuba2_probe.py``: the step of nine
quarter-size negacyclic products (0.5625x the multiply-adds), one tree
combine per limb, multiply extract (``karatsuba_probe.step_k2``), checked
on the card against K1, then timed beside K1.  Same inputs (numpy seed 7,
in the same order) and rate as the JAX probe.  The JAX script's levels-1
line ("karatsuba1") runs the port's K1 (``cmux_k.cmux_step``, standard
layout); its panel depth tm=256 and its per-step panel build (fastbuild)
have no Hopper counterpart, so those lines run the same kernel and say so.

Usage: python -m rustfhe_tpu_torch.benches.karatsuba2_probe [B]
"""

from __future__ import annotations

import sys

import torch

from ..engine import cmux_k, karatsuba
from ..engine import karatsuba_probe as kp
from ..params import DEFAULT_PARAMS as P
from . import _timing
from ._timing import Case
from .k2_floor_probe import MACS_FULL, TB_NOTE
from .vpu_reduce_probe import draw, parse

DEFAULT_B = 8192
NO_PANELS = {"tm=256": "the TPU's 256-deep contraction panels",
             "fastbuild": "the TPU's per-step panel build"}


def checks(device, out=print) -> None:
    """P1 against K1 on the same rows, through the scan layout."""
    (flat, ai, tab, key, acc), _, _ = draw(1, device)
    got = karatsuba.scan_exit(kp.step_k2(flat, ai, tab, P))
    want = cmux_k.cmux_step(acc, ai, key, P)
    ok = torch.equal(got, want)
    out(f"karatsuba2 step exact on device: {ok}")
    if not ok:
        raise AssertionError(f"P1 differs from K1 in {int((got != want).sum())} words")


def cases(B: int, device) -> list:
    (_, _, tab, key, _), acc0, a_t = draw(B, device)
    ops = 2 * B * MACS_FULL

    def k2(a):
        return kp.step_k2(a, a_t, tab, P)

    out = [Case("karatsuba1 (prebuilt, prod) -> port K1, standard layout",
                lambda a: cmux_k.cmux_step(a, a_t, key, P), karatsuba.scan_exit(acc0), ops),
           Case("karatsuba2 tm=128 (prebuilt)", k2, acc0, ops)]
    for name, what in NO_PANELS.items():
        out.append(f"# {name}: {what}, no Hopper counterpart (the port reads no panels); "
                   "the same kernel")
        out.append(Case(f"karatsuba2 {name}" if name != "fastbuild" else "karatsuba2 + fastbuild",
                        k2, acc0, ops))
    return out


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """Check, then time every line at batch B on the card; {line: seconds per step}."""
    device = _timing.require_cuda()
    _timing.header("two-level Karatsuba step, limb-outer (P1)", B, out)
    out(TB_NOTE)
    checks(device, out)
    return _timing.run_cases(cases(B, device), steps, reps, out)


def main(argv=None) -> int:
    run(parse(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
