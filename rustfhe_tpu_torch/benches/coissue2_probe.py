"""Where the Karatsuba step builds its tree planes, on the card (P3).

Counterpart of ``benches/coissue2_probe.py``, which asks whether building
each leaf's operand planes next to its products lets the TPU co-issue the
vector work with the matrix unit.  On the card (``karatsuba_probe.
step_coissue``): the digit kernel writes the four residue leaves alone, and
the leaf product's producer warpgroup builds each sum leaf's tree planes
from them, stage by stage, into the swizzled ring just before their
``wgmma``s (B), or with the stage's key boxes requested before the build
(C), against the upfront build (A, ``step_var``'s leaf-first
multiply-extract form: all nine leaves through device memory).  Same inputs (numpy seed 7, in the same
order) as the JAX probe; B and C are checked first on 256 samples against
the ``"matmul"`` engine's acc + ExtProd(key, Decompose(X^a~ * acc - acc)),
through the scan layout, as the JAX script does.

Usage: python -m rustfhe_tpu_torch.benches.coissue2_probe [B]
"""

from __future__ import annotations

import sys

import torch

from .. import poly
from ..engine import karatsuba
from ..engine import karatsuba_probe as kp
from ..engine.matmul import MatmulEngine
from ..params import DEFAULT_PARAMS as P
from ..trgsw import decompose_trlwe
from . import _timing
from ._timing import Case
from .k2_floor_probe import MACS_FULL, TB_NOTE
from .vpu_reduce_probe import draw, parse

DEFAULT_B = 8192
LINES = {"A: baseline (upfront planes, prebuilt)": None,
         "B: per-leaf JIT build (prebuilt)": False,
         "C: software-pipelined (prebuilt)": True}


def checks(device, out=print) -> None:
    """B and C against the matmul engine's step on the check's 256 samples."""
    (flat, ai, tab, key, acc), _, _ = draw(1, device)
    m = MatmulEngine()
    rows = key[..., P.N:]  # the K1 table is [-rows, rows]
    diff = poly.rotate(acc, ai[:, None]) - acc
    want = acc + m.external_product_digits(m.prepare_trgsw(rows, P), decompose_trlwe(diff, P), P)
    for tag, pipe in (("leafJIT", False), ("pipelined", True)):
        ok = torch.equal(karatsuba.scan_exit(kp.step_coissue(flat, ai, tab, P, pipe)), want)
        out(f"exact[{tag}]: {ok}")
        if not ok:
            raise AssertionError(f"P3 {tag} differs from the matmul engine's step")


def cases(B: int, device) -> list:
    (_, _, tab, _, _), acc0, a_t = draw(B, device)
    ops = 2 * B * MACS_FULL

    def step(pipe):
        if pipe is None:
            return lambda a: kp.step_var(a, a_t, tab, P)
        return lambda a: kp.step_coissue(a, a_t, tab, P, pipe)

    return [Case(name, step(pipe), acc0, ops) for name, pipe in LINES.items()]


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """Check, then time every line at batch B on the card; {line: seconds per step}."""
    device = _timing.require_cuda()
    _timing.header("Karatsuba step, tree-plane build order (P3)", B, out)
    out(TB_NOTE)
    checks(device, out)
    return _timing.run_cases(cases(B, device), steps, reps, out)


def main(argv=None) -> int:
    run(parse(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
