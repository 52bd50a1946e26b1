"""The CMux step at N=2048 (N2048_PARAMS): exact, then ms per step.

Counterpart of ``benches/n2048_probe.py``, which ran the JAX Karatsuba
kernel at levels 1 and 2.  Here:

  K1            the port's production step (``cmux_k.cmux_step``), standing
                in for the JAX probe's levels=1
  P4 levels=2   the two-level Karatsuba step (``karatsuba_probe.
                step_ablate``, "full") in the residue layout

Both must equal the ``"matmul"`` engine's composed step (the rotation, the
difference, the decomposition, the int8-GEMM product and the add) on 256
random rows (numpy seed 7) word for word; a shape check that refused one
would raise.  Then ms per step at batch B, as chains between CUDA events
(``_timing.chain``), and the gates/s that a rotation of n steps at that
step time would give.

Usage: python -m rustfhe_tpu_torch.benches.n2048_probe [B]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import _u32, poly
from ..engine import cmux_k, get_engine, karatsuba, plain
from ..engine import karatsuba_probe as kp
from ..params import N2048_PARAMS as P
from ..params import TFHEParams
from ..trgsw import decompose_trlwe
from . import _timing
from ._timing import Case
from .k2_floor_probe import macs

DEFAULT_B = 4096
CHECK_ROWS = 256
LEVELS = {1: "K1 cmux_step (levels=1)", 2: "P4 Karatsuba full (levels=2)"}


def step(levels: int, acc, a_t, rows, params: TFHEParams):
    """(step function, its first input) in the form's layout."""
    if levels == 1:
        key = plain.prepare_trgsw(rows)
        return (lambda a: cmux_k.cmux_step(a, a_t, key, params)), acc
    table = karatsuba.prepare_table(rows)
    tm = min(kp.TM, params.N // karatsuba.R)  # read by "nodots" alone; must divide ns
    return ((lambda a: kp.step_ablate(a, a_t, table, params, "full", tm)),
            karatsuba.scan_enter(acc))


def composed(acc, a_t, rows, params: TFHEParams) -> torch.Tensor:
    """The "matmul" engine's step: acc + ExtProd(rows, Decompose(X^a acc - acc))."""
    m = get_engine("matmul")
    diff = poly.rotate(acc, a_t[:, None]) - acc
    return acc + m.external_product_digits(m.prepare_trgsw(rows, params),
                                           decompose_trlwe(diff, params), params)


def checks(device, params: TFHEParams = P, rows_n: int = CHECK_ROWS, out=print) -> None:
    """Each form against the composed step on ``rows_n`` rows; raises on a
    difference."""
    rs = np.random.RandomState(7)
    rows = _u32.from_numpy(rs.randint(0, 2**32, size=(2 * params.l, 2, params.N),
                                      dtype=np.uint64), device)
    acc = _u32.from_numpy(rs.randint(0, 2**32, size=(rows_n, 2, params.N), dtype=np.uint64),
                          device)
    ai = torch.from_numpy(rs.randint(0, 2 * params.N, size=(rows_n,)).astype(np.int32))
    ai = ai.to(device)
    want = composed(acc, ai, rows, params)
    for levels, name in LEVELS.items():
        fn, x = step(levels, acc, ai, rows, params)
        got = fn(x) if levels == 1 else karatsuba.scan_exit(fn(x))
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from the matmul engine's step at N={params.N}")
        out(f"{name}: exact against the matmul engine's step on {rows_n} rows at N={params.N}")


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """Check, then time both forms at batch B on the card; {form: seconds per step}."""
    device = _timing.require_cuda()
    _timing.header(f"CMux step at N={P.N} (N2048_PARAMS, l={P.l})", B, out)
    checks(device, out=out)
    rs = np.random.RandomState(8)
    rows = _u32.from_numpy(rs.randint(0, 2**32, size=(2 * P.l, 2, P.N), dtype=np.uint64), device)
    acc = _u32.from_numpy(rs.randint(0, 2**32, size=(B, 2, P.N), dtype=np.uint64), device)
    a_t = torch.from_numpy(rs.randint(0, 2 * P.N, size=(B,)).astype(np.int32)).to(device)
    times = {}
    for levels, name in LEVELS.items():
        fn, x0 = step(levels, acc, a_t, rows, P)
        dt = _timing.chain(Case(name, fn, x0, 2 * B * macs(P)), steps, reps, out)
        out(f"#   {name}: -> ~{B / (dt * P.n):,.0f} gates/s at B={B} (n={P.n} steps)")
        times[name] = dt
    return times


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else DEFAULT_B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
