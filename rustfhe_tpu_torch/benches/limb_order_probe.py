"""The merged limb step's two recombination orders, on the card (P5).

Counterpart of ``benches/limb_order_probe.py``: the merged limb step (both
output halves per block) with the limbs recombined after every plane j
("j-outer", ``(uint32) part << 8k`` per (j, k)) against once per (half,
limb) after all planes ("limb-outer", the TPU K4's order), through the
probe kernel ``limb_probe.step_order`` in the limb step's ``__dp4a`` form
(both held to K4 word for word), in turns, twice; then K4 itself, the
int8 ``wgmma`` GEMM, which recombines once per (half, limb) in its
epilogue.  Same inputs (numpy seed 0) and rate as the JAX probe.

Usage: python -m rustfhe_tpu_torch.benches.limb_order_probe [B]
"""

from __future__ import annotations

import sys

import numpy as np

from ..engine import limb_probe, limb_step
from ..params import DEFAULT_PARAMS as P
from . import _timing
from ._timing import Case
from .step_breakdown_probe import MACS_PER_GATE_STEP, step_inputs

DEFAULT_B = 8192


def cases(B: int, device) -> list:
    acc0, a_t, tab = step_inputs(B, device, np.random.RandomState(0))
    ops = 2 * B * MACS_PER_GATE_STEP
    out = []
    for rep in range(2):
        for order in ("j-outer", "limb-outer"):
            out.append(Case(f"rep{rep} {order} (P5)",
                            lambda a, order=order: limb_probe.step_order(a, a_t, tab, P, order),
                            acc0, ops))
    out.append(Case("K4 (cmux_step_merged)",
                    lambda a: limb_step.cmux_step_merged(a, a_t, tab, P), acc0, ops))
    return out


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """Time both orders at batch B on the card; {line name: seconds per step}."""
    device = _timing.require_cuda()
    _timing.header("limb order (P5)", B, out)
    return _timing.run_cases(cases(B, device), steps, reps, out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else DEFAULT_B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
