"""The Karatsuba step with its digit-side work varied, on the card (P8).

Counterpart of ``benches/vpu_reduce_probe.py``: the same lines, the same
inputs (numpy seed 7, drawn in the same order), checked on the card against
K1 before timing, through ``karatsuba_probe.step_var``:

  a) the recombination order: leaf-first (one tree combine) against
     limb-outer (a combine per limb);
  b) the tree sums: int32 against packed (the TPU probe's "int16 planes":
     on the card the levels' digits of a residue are the bytes of one word,
     summed four lanes per ``__vadd4``);
  c) the digit extract: multiply, shift-subtract, shift/arithmetic-shift;
  d) two steps per call (unroll2): step 2's digits need every word of step
     1 (the rotation mixes all positions), so the card runs the two steps
     one after the other and the intermediate accumulator goes through
     device memory;
  and, inexact, the rotation skipped (diff = 1).

The JAX script's levels-1 line runs the port's K1 (``cmux_k.cmux_step``,
the standard layout); its "fastbuild" panel build has no counterpart.

Usage: python -m rustfhe_tpu_torch.benches.vpu_reduce_probe [B]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..engine import cmux_k, karatsuba
from ..engine import karatsuba_probe as kp
from ..params import DEFAULT_PARAMS as P
from . import _timing
from ._timing import Case
from .k2_floor_probe import MACS_FULL, TB_NOTE, draw_acc, draw_step

DEFAULT_B = 8192
CHECK_B = 256
# The single-step lines of the JAX script (its names) and the checked forms.
LINES = {
    "k2 limb_outer (old prod)": "limb_outer",
    "k2 leaf_u32 (new prod)": "leaf_u32",
    "k2 leaf_u32 + int16 planes": "int16",
    "k2 leaf_u32 + shift extract": "shift",
    "k2 leaf_u32 + int16 + shift": "int16+shift",
    "k2 leaf_u32 + sar extract": "sar",
    "k2 [attr] skip_rotate (inexact)": "skip_rotate",
    "k2 [attr] skip_rotate + sar (inexact)": "skip_rotate+sar",
}
CHECKS = {"leaf_u32": "leaf_u32", "limb_outer(old)": "limb_outer", "leaf+int16": "int16",
          "leaf+shiftext": "shift", "leaf+sarext": "sar"}


def draw(B: int, device):
    """Seed 7 in the JAX script's order: the check's rows, acc and a~
    (CHECK_B samples), then the timed acc and a~ (B samples)."""
    rs = np.random.RandomState(7)
    check = draw_step(rs, CHECK_B, device)
    acc, a_t = draw_acc(rs, B, device)
    return check, karatsuba.scan_enter(acc), a_t


def checks(device, out=print) -> None:
    """Each exact single-step form against K1 on the same rows, through
    the scan layout; then unroll2 against two single steps.  Raises on a
    difference."""
    (flat, ai, tab, key, acc), _, _ = draw(1, device)
    want = cmux_k.cmux_step(acc, ai, key, P)
    for tag, form in CHECKS.items():
        got = kp.step_var(flat, ai, tab, P, **kp.VAR_FORMS[form])
        ok = torch.equal(karatsuba.scan_exit(got), want)
        out(f"exact[{tag}]: {ok}")
        if not ok:
            raise AssertionError(f"P8 {tag} differs from K1")
    ai2 = torch.stack([ai, (ai * 7 + 3) % (2 * P.N)], dim=1)
    one = kp.step_var(flat, ai, tab, P)
    two_ref = kp.step_var(one, ai2[:, 1].contiguous(), tab, P)
    ok = torch.equal(kp.step_var(flat, ai2, torch.stack([tab, tab]), P, unroll=2), two_ref)
    out(f"exact[unroll2]: {ok}")
    if not ok:
        raise AssertionError("P8 unroll2 differs from two single steps")


def cases(B: int, device) -> list:
    (_, _, tab, key, _), acc0, a_t = draw(B, device)
    ops = 2 * B * MACS_FULL
    out = [Case(name, lambda a, kw=kp.VAR_FORMS[form]: kp.step_var(a, a_t, tab, P, **kw), acc0,
                ops) for name, form in LINES.items()]
    a_t2 = torch.stack([a_t, a_t], dim=1)
    tabs = torch.stack([tab, tab])
    out.append("# unroll2: step 2's digits need every word of step 1 (the rotation mixes "
               "all positions): two steps of four launches per call")
    out.append(Case("k2 leaf_u32 unroll2 (prebuilt)",
                    lambda a: kp.step_var(a, a_t2, tabs, P, unroll=2), acc0, ops,
                    steps_per_call=2))
    out.append("# production lines: the TPU's per-step panel build (fastbuild) has no Hopper "
               "counterpart; levels 1 is the port's K1 in the standard layout")
    std0 = karatsuba.scan_exit(acc0)
    out.append(Case("k1 production cmux_step (port K1, standard layout)",
                    lambda a: cmux_k.cmux_step(a, a_t, key, P), std0, ops))
    out.append(Case("k2 production cmux_step (Karatsuba step)",
                    lambda a: kp.step_var(a, a_t, tab, P, extract="sar"), acc0, ops))
    return out


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """Check, then time every line at batch B on the card; {line: seconds per step}."""
    device = _timing.require_cuda()
    _timing.header("Karatsuba step digit-side variants (P8)", B, out)
    out(TB_NOTE)
    checks(device, out)
    return _timing.run_cases(cases(B, device), steps, reps, out)


def parse(argv) -> int:
    return int(argv[0]) if argv else DEFAULT_B


def main(argv=None) -> int:
    run(parse(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
