"""The production CMux step: exact against the composed step, then timed.

Counterpart of ``benches/karatsuba_probe.py``, which held the JAX fused
Karatsuba step to the composed ``"matmul"`` path and timed it beside the
merged limb kernel.  Here:

  exactness  K1 (``cmux_k.cmux_step``, the port's production step) against
             the ``"matmul"`` engine's composed step (the rotation, the
             difference, the decomposition, the int8-GEMM product and the
             add) on 256 random rows at DEFAULT_PARAMS (numpy seed 7), word
             for word; any device
  speed      at batch B on the card: K1 with its key panel built in the
             step, K1 on a prebuilt panel (``cmux_k.cmux_step_panel``), and
             K4 (``limb_step.cmux_step_merged``, the JAX probe's "merged"
             kernel) on the limb table of the same rows

Timing: chains between CUDA events (``_timing.chain``).  The JAX probe's
batch tiles (tb = 128, 256, 512) have no counterpart: the port's kernels
tile by 128 samples.

Usage: python -m rustfhe_tpu_torch.benches.karatsuba_probe [B]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import _u32
from ..engine import cmux_k, limb_step, plain
from ..params import DEFAULT_PARAMS as P
from ..params import TFHEParams
from . import _timing
from ._timing import Case
from .k2_floor_probe import draw_acc, macs
from .n2048_probe import composed

DEFAULT_B = 8192
CHECK_ROWS = 256


def draw(rs: np.random.RandomState, B: int, device, params: TFHEParams = P):
    """rows (2L, 2, N), then acc (B, 2, N) and a~ (B,), from ``rs``."""
    rows = _u32.from_numpy(rs.randint(0, 2**32, size=(2 * params.l, 2, params.N),
                                      dtype=np.uint64), device)
    return (rows,) + draw_acc(rs, B, device, params)


def checks(device, params: TFHEParams = P, rows_n: int = CHECK_ROWS, out=print) -> None:
    """K1 against the composed step; raises on a difference."""
    rows, acc, a_t = draw(np.random.RandomState(7), rows_n, device, params)
    got = cmux_k.cmux_step(acc, a_t, plain.prepare_trgsw(rows), params)
    if not torch.equal(got, composed(acc, a_t, rows, params)):
        raise AssertionError("K1 differs from the matmul engine's composed step")
    out(f"K1 step exact against the composed matmul step on {rows_n} rows ({device}): True")


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """Check, then time the three steps at batch B on the card; {line:
    seconds per step}."""
    device = _timing.require_cuda()
    _timing.header("the production CMux step (K1, K4)", B, out)
    checks(device, P, out=out)
    rows, acc, a_t = draw(np.random.RandomState(7), B, device, P)
    key, limbs = plain.prepare_trgsw(rows), plain.prepare_trgsw_limbs(rows)
    panel = cmux_k.key_panel(key, P)
    ops = 2 * B * macs(P)
    return _timing.run_cases([
        Case("K1 cmux_step (panel per step)", lambda a: cmux_k.cmux_step(a, a_t, key, P), acc,
             ops),
        Case("K1 cmux_step_panel (prebuilt panel)",
             lambda a: cmux_k.cmux_step_panel(a, a_t, panel, P), acc, ops),
        Case("K4 limb cmux_step_merged", lambda a: limb_step.cmux_step_merged(a, a_t, limbs, P),
             acc, ops),
    ], steps, reps, out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else DEFAULT_B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
