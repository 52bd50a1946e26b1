"""The circuit optimizer's A/B on the level-fused evaluator.

Counterpart of ``benches/optimizer_probe.py``.  Two arms of
``apps.circuits.evaluate_encrypted`` on ``prefix_comparator(16)`` and
``comparator(8)`` (the NOT-heavy legacy cell) at a leading batch of 64:

  on   the evaluator as it is: ``circuits.optimize`` (exact CSE + DCE) and
       ``lower_folded`` (NOT gates folded into the coefficient signs)
  off  ``circuits.optimize`` as the identity and ``lower_folded`` through
       plain ``lower`` (``lower_unfolded``: NOT gates stay bootstrap lanes),
       swapped into the module and restored in a ``finally``

Each arm's levels and lanes come from its plan (``plan``, no bootstrap);
each arm's outputs must decrypt to ``circuits.evaluate_plain``'s.  It runs
on the card at DEFAULT_PARAMS (``run``), and, as the JAX script does, on
the CPU at TEST_PARAMS (``--cpu``), where the times are the CPU's.
Timing: the host clock around one evaluation and its decryption, the card
synchronised (``utils.timing.time_fn``), the best of REPS after a warm-up.

Usage: python -m rustfhe_tpu_torch.benches.optimizer_probe [--cpu]
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

from ..apps import circuits as C
from ..context import TFHE
from ..gates import PRE_COEFFS
from ..params import DEFAULT_PARAMS, TEST_PARAMS
from ..utils.timing import time_fn
from . import _timing

B = 64  # leading batch: bootstrap lanes dominate a level's dispatch
REPS = 3


def cases() -> list[tuple[str, C.Circuit]]:
    return [("prefix_comparator(16)", C.prefix_comparator(16)),
            ("comparator(8) [NOT-heavy legacy cell]", C.comparator(8))]


def lower_unfolded(circuit: C.Circuit):
    """Plain ``lower`` in the ``lower_folded`` return contract: NOT gates
    stay bootstrap lanes."""
    ops, in_a, in_b, out_w, n_wires = C.lower(circuit)
    coeff = (np.array([PRE_COEFFS[o] for o in ops], np.int64).reshape(-1, 3)
             if len(ops) else np.zeros((0, 3), np.int64))
    return (coeff, in_a, in_b, out_w, n_wires, np.array(circuit.outputs, np.int64),
            np.zeros(len(circuit.outputs), bool))


@contextlib.contextmanager
def arm(on: bool):
    """The evaluator with the optimizer on, or off (swapped in, restored)."""
    if on:
        yield
        return
    orig = C.optimize, C.lower_folded
    C.optimize, C.lower_folded = (lambda c: c), lower_unfolded
    try:
        yield
    finally:
        C.optimize, C.lower_folded = orig


def plan(circuit: C.Circuit, on: bool) -> tuple[int, int, int]:
    """(gates, levels, lanes per sample) of the arm's evaluation plan."""
    with arm(on):
        c = C.optimize(circuit)
        widths = C._level_plan(c, None)[0]
    return len(c.gates), len(widths), sum(widths)


def compare(ctx: TFHE, out=print, clock: str = "host clock") -> dict:
    """Both arms on each case on ``ctx``; {(case, arm): seconds}."""
    rs = np.random.RandomState(0)
    times = {}
    for name, circ in cases():
        bits = rs.randint(0, 2, size=(B, circ.n_inputs)).astype(np.int32)
        cts = ctx.encrypt(bits)
        want = C.evaluate_plain(circ, bits)

        def one():
            got = ctx.decrypt(C.evaluate_encrypted(circ, ctx, cts)).cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"{name}: outputs differ from evaluate_plain")

        for on in (True, False):
            with arm(on):
                best, _ = time_fn(one, iters=REPS, device=ctx.device)  # warm-up: the check
            times[(name, on)] = best
        g_on, lv_on, la_on = plan(circ, True)
        g_off, lv_off, la_off = plan(circ, False)
        t_on, t_off = times[(name, True)], times[(name, False)]
        out(f"{name}: gates {g_off} -> {g_on}; levels {lv_off} -> {lv_on}; lanes/sample "
            f"{la_off} -> {la_on} (x{B}); wall {t_off * 1e3:.0f} -> {t_on * 1e3:.0f} ms "
            f"({t_off / t_on:.2f}x, {clock}, best of {REPS}); outputs right in both arms")
    return times


def run(out=print) -> dict:
    """The A/B on the card at DEFAULT_PARAMS."""
    device = _timing.require_cuda()
    ctx = TFHE.new(5, DEFAULT_PARAMS, device=device)
    out(f"# optimizer A/B at DEFAULT_PARAMS on {_timing.card()} [{ctx.engine_name}], B={B}")
    return compare(ctx, out)


def run_cpu(out=print) -> dict:
    """The JAX script's run: TEST_PARAMS on the CPU, CPU wall times."""
    ctx = TFHE.new(5, TEST_PARAMS, device="cpu", engine_name="matmul")
    out(f"# optimizer A/B at TEST_PARAMS on the CPU [matmul], B={B}")
    return compare(ctx, out, clock="CPU wall clock")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--cpu" in argv:
        run_cpu()
    else:
        run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
