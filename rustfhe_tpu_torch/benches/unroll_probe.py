"""Steps per call and the panel build's share of a step.

Counterpart of ``benches/unroll_probe.py``: the Karatsuba step (P8,
``karatsuba_probe.step_var``, its leaf-first multiply-extract form) at
unroll 1, 2 and 4, in two forms:

  per-step build  the whole step: tree digits, the leaf panels built from
                  the leaf table, the nine leaf products, the combine
  prebuilt        the same step on leaf panels built once
                  (``karatsuba_probe.tree_digits`` + ``leaves`` +
                  ``combine`` on one ``leaf_panel``)

then, beside them, K1 with its key panel built in the step
(``cmux_k.cmux_step``) and on a prebuilt panel (``cmux_k.cmux_step_panel``).
The question: how much of a step the panel build costs.  On the card an
unrolled call runs its steps one after the other (each step's digits need
every word of the step before), so unroll changes the launches' grouping,
not their number.

Before any timing, on the card: unroll 4 equal to four single steps, the
prebuilt step equal to the per-step one, and K1 on its prebuilt panel
equal to K1, word for word (``checks`` runs on any device).  Inputs: numpy
seed 7 (rows, acc, a~), as the JAX script draws them.  Timing: chains
between CUDA events (``_timing.chain``), per step.

Usage: python -m rustfhe_tpu_torch.benches.unroll_probe [B]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..engine import cmux_k, karatsuba
from ..engine import karatsuba_probe as kp
from ..params import DEFAULT_PARAMS as P
from ..params import TFHEParams
from . import _timing
from ._timing import Case
from .k2_floor_probe import draw_step, macs

DEFAULT_B = 8192
UNROLLS = (1, 2, 4)
FORM = kp.var_form()  # step_var's default: leaf-first, multiply extract


def prebuilt_step(acc, a_tilde, panel, table, params: TFHEParams, form=FORM) -> torch.Tensor:
    """One P8 step of ``form`` on prebuilt leaf panels: tree digits,
    leaves, combine."""
    digits = kp.tree_digits(acc, a_tilde, params, form)
    tm = min(kp.TM, params.N // karatsuba.R)  # read by "nodots" alone; must divide ns
    return kp.combine(acc, kp.leaves(digits, panel, table, params, form, tm), params, form)


def stacked(a_t: torch.Tensor, table: torch.Tensor, u: int, params: TFHEParams):
    """a~ (B, u), a different rotation per step, and u copies of the table."""
    a_u = torch.stack([(a_t * (2 * s + 1) + s) % (2 * params.N) for s in range(u)], dim=1)
    return a_u.to(torch.int32).contiguous(), torch.stack([table] * u)


def checks(device, params: TFHEParams = P, B: int = 256, out=print) -> None:
    """On ``device``: unroll 4 = four single steps, prebuilt = per-step
    build, K1 on its prebuilt panel = K1; raises on a difference."""
    flat, a_t, table, key, acc = draw_step(np.random.RandomState(7), B, device, params)
    a4, tabs = stacked(a_t, table, 4, params)
    want = flat
    for s in range(4):
        want = kp.step_var(want, a4[:, s].contiguous(), table, params)
    if not torch.equal(kp.step_var(flat, a4, tabs, params, unroll=4), want):
        raise AssertionError("P8 unroll 4 differs from four single steps")
    panel = kp.leaf_panel(table, params)
    if not torch.equal(prebuilt_step(flat, a_t, panel, table, params),
                       kp.step_var(flat, a_t, table, params)):
        raise AssertionError("P8 on prebuilt leaf panels differs from the per-step build")
    if not torch.equal(cmux_k.cmux_step_panel(acc, a_t, cmux_k.key_panel(key, params), params),
                       cmux_k.cmux_step(acc, a_t, key, params)):
        raise AssertionError("K1 on a prebuilt panel differs from K1")
    out(f"# exact on {device}: unroll 4 = four single steps; prebuilt = per-step build; "
        "K1 on its prebuilt panel = K1")


def cases(B: int, device) -> list:
    flat, a_t, table, key, acc = draw_step(np.random.RandomState(7), B, device, P)
    panel = kp.leaf_panel(table, P)
    ops = 2 * B * macs(P)
    out = []
    for u in UNROLLS:
        a_u, tabs = stacked(a_t, table, u, P)
        cols = [a_u[:, s].contiguous() for s in range(u)]
        if u == 1:
            out.append(Case("p8 unroll1 per-step build", lambda a: kp.step_var(a, a_t, table, P),
                            flat, ops))
        else:
            out.append(Case(f"p8 unroll{u} per-step build",
                            lambda a, a_u=a_u, tabs=tabs, u=u: kp.step_var(a, a_u, tabs, P,
                                                                            unroll=u),
                            flat, ops, steps_per_call=u))

        def pre(a, cols=cols):
            for c in cols:
                a = prebuilt_step(a, c, panel, table, P)
            return a

        out.append(Case(f"p8 unroll{u} prebuilt", pre, flat, ops, steps_per_call=u))
    k1_panel = cmux_k.key_panel(key, P)
    out.append("# K1 (standard layout): its key panel built in the step, then prebuilt")
    out.append(Case("k1 cmux_step (panel per step)", lambda a: cmux_k.cmux_step(a, a_t, key, P),
                    acc, ops))
    out.append(Case("k1 cmux_step_panel (prebuilt)",
                    lambda a: cmux_k.cmux_step_panel(a, a_t, k1_panel, P), acc, ops))
    return out


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """Check, then time every line at batch B on the card, then the panel
    build's share; {line: seconds per step}."""
    device = _timing.require_cuda()
    _timing.header("step unroll x panel build (P8, K1)", B, out)
    checks(device, P, out=out)
    t = _timing.run_cases(cases(B, device), steps, reps, out)
    out("# the panel build's share of a step (per-step build - prebuilt):")
    for u in UNROLLS:
        d = t[f"p8 unroll{u} per-step build"] - t[f"p8 unroll{u} prebuilt"]
        whole = t[f"p8 unroll{u} per-step build"]
        out(f"#   p8 unroll{u}: {d * 1e3:+.4f} ms ({d / whole:.1%})")
    d = t["k1 cmux_step (panel per step)"] - t["k1 cmux_step_panel (prebuilt)"]
    out(f"#   k1: {d * 1e3:+.4f} ms ({d / t['k1 cmux_step (panel per step)']:.1%})")
    return t


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else DEFAULT_B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
