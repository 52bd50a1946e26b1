"""The Karatsuba step with the block's tile split in two, on the card (P2).

Counterpart of ``benches/coissue_probe.py``, which asks whether the TPU
co-issues one sub-tile's vector work with another's matrix products.  On
the card the digits are built apart from the leaf product, and its block
tile of 128 samples is taken as two sub-tiles of 64
(``karatsuba_probe.step_split``): in turn, each sub-tile's stages through
the ring to one consumer warpgroup, the key boxes loaded twice (serial),
or by the two warpgroups together, the product's own tile (grouped),
against the unsplit Karatsuba step.  Same inputs (numpy seed
7, in the same order) as the JAX probe, checked on the card against the
unsplit step first.  The TPU's batch tile tb=256 has no counterpart.

Usage: python -m rustfhe_tpu_torch.benches.coissue_probe [B]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..engine import karatsuba_probe as kp
from ..params import DEFAULT_PARAMS as P
from . import _timing
from ._timing import Case
from .k2_floor_probe import MACS_FULL, TB_NOTE, draw_step
from .vpu_reduce_probe import CHECK_B, parse

DEFAULT_B = 8192


def draw(B: int, device):
    """Seed 7 in the JAX script's order: rows, then acc and a~ (B samples)."""
    acc0, a_t, tab, _, _ = draw_step(np.random.RandomState(7), B, device)
    return acc0, a_t, tab


def checks(B: int, device, out=print) -> None:
    """Both split orders against the unsplit step on the first samples."""
    acc0, a_t, tab = draw(B, device)
    b = min(B, CHECK_B)
    acc, a = acc0[:b].contiguous(), a_t[:b].contiguous()
    want = kp.step_ablate(acc, a, tab, P, "full")
    for grouped in (False, True):
        ok = torch.equal(kp.step_split(acc, a, tab, P, grouped), want)
        out(f"split-{kp.SPLITS[grouped]} exact: {ok}")
        if not ok:
            raise AssertionError(f"P2 {kp.SPLITS[grouped]} differs from the unsplit step")


def cases(B: int, device) -> list:
    acc0, a_t, tab = draw(B, device)
    ops = 2 * B * MACS_FULL

    def full(a):
        return kp.step_ablate(a, a_t, tab, P, "full")

    return [Case("baseline (Karatsuba step)", full, acc0, ops),
            Case("split-serial (2x64)", lambda a: kp.step_split(a, a_t, tab, P, False), acc0,
                 ops),
            Case("split-grouped (2x64)", lambda a: kp.step_split(a, a_t, tab, P, True), acc0,
                 ops),
            "# baseline tb=256: the TPU's batch tile has no counterpart; the same kernel",
            Case("baseline tb=256 -> Karatsuba step", full, acc0, ops)]


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """Check, then time every line at batch B on the card; {line: seconds per step}."""
    device = _timing.require_cuda()
    _timing.header("Karatsuba step, tile split in two sub-tiles (P2)", B, out)
    out(TB_NOTE)
    checks(B, device, out)
    return _timing.run_cases(cases(B, device), steps, reps, out)


def main(argv=None) -> int:
    run(parse(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
