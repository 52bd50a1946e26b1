"""Where the limb step's time goes, on the card (P6, P7).

Counterpart of ``benches/step_breakdown_probe.py``: the same variants, the
same inputs (numpy seed 0, drawn in the same order) and the same rates,
timed by ``_timing.chain``:

  full      K6 (``limb_step.cmux_step_split``, the int8 wgmma GEMM) and
            P6's "full", K6's kernels through the probe's library (held to
            K6 word for word)
  merged    K4 (``limb_step.cmux_step_merged``); also run with "full"
  nodots    P6: K6's step with the product replaced by a digit sum
            broadcast over N
  norot     P6: K6's step on the digits of acc itself (no rotation)
  dots      P7: the bare int8 dot (B, 6144) @ (6144, 1024) on the tensor
            cores at each tile of ``int8_gemm.TILES``, beside
            ``torch._int_mm`` (cuBLASLt, the library yardstick, not the port)
  tm256, wide, fastbuild
            vary the TPU's panel depth and panel build; K4/K6 build one
            panel set per step (128-byte slices, one kernel), so these
            launch K4/K6 at the probe's shape and say so

Usage: python -m rustfhe_tpu_torch.benches.step_breakdown_probe [B] [which ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import _u32
from ..engine import int8_gemm, limb_probe, limb_step, plain
from ..params import DEFAULT_PARAMS as P
from . import _timing
from ._timing import Case

DEFAULT_B = 8192
DEFAULT_WHICH = ("full", "nodots", "norot", "tm256", "dots")
KNOWN = ("full", "merged", "nodots", "norot", "tm256", "wide", "fastbuild", "dots")
MACS_PER_GATE_STEP = 2 * P.l * P.N * 2 * 4 * P.N  # 50.3M
K_DOT = 6144  # the step's contraction depth 2L*N
NO_PANELS = {
    "tm256": "the TPU's 256-deep contraction panels",
    "wide": "the TPU's 1024-deep panels and their XLA build",
    "fastbuild": "the TPU's log-doubling panel build",
}


def step_inputs(B: int, device, rs: np.random.RandomState):
    """acc0, a~ and the limb table from the JAX probe's random ``qd``."""
    acc0 = _u32.from_numpy(rs.randint(0, 2**32, size=(B, 2, P.N), dtype=np.uint64), device)
    a_t = torch.from_numpy(rs.randint(0, 2 * P.N, size=(B,)).astype(np.int32)).to(device)
    qd = torch.from_numpy(rs.randint(-128, 128, size=(2, 2 * P.l * 4, 2 * P.N)).astype(np.int8))
    return acc0, a_t, plain.limb_table_from_qd(qd).to(device)


def dot_inputs(B: int, device, rs: np.random.RandomState):
    """w (6144, N) and d0 (B, 6144), drawn after the step inputs."""
    w = torch.from_numpy(rs.randint(-128, 128, size=(K_DOT, P.N)).astype(np.int8)).to(device)
    d0 = torch.from_numpy(rs.randint(-32, 32, size=(B, K_DOT)).astype(np.int8)).to(device)
    return w, d0


def cases(B: int, which, device) -> list:
    """The timed Cases of ``which`` (and notes, as str) in the JAX probe's
    order."""
    rs = np.random.RandomState(0)
    acc0, a_t, tab = step_inputs(B, device, rs)
    ops = 2 * B * MACS_PER_GATE_STEP

    def k4(a):
        return limb_step.cmux_step_merged(a, a_t, tab, P)

    def k6(a):
        return limb_step.cmux_step_split(a, a_t, tab, P)

    def variant(name):
        return Case(f"{name} (P6)", lambda a: limb_probe.step_variant(a, a_t, tab, P, name),
                    acc0, ops)

    out = ["# the TPU's batch tile tb has no counterpart: a P6 and K4/K6 block tile holds "
           "128 samples"]
    if "full" in which:
        out += [Case("full (K6)", k6, acc0, ops), variant("full")]
    if "merged" in which or "full" in which:
        out.append(Case("merged (K4)", k4, acc0, ops))
    for name in ("nodots", "norot"):
        if name in which:
            out.append(variant(name))
    for name, what in NO_PANELS.items():
        if name in which:
            out.append(f"# {name}: {what} have no Hopper counterpart (K4/K6 build one "
                       "panel set per step); K4 and K6 at the probe's shape")
            out += [Case(f"{name} -> K4", k4, acc0, ops), Case(f"{name} -> K6", k6, acc0, ops)]
    if "dots" in which:
        w, d0 = dot_inputs(B, device, rs)
        wt = int8_gemm.prepare_rhs(w)  # once, outside the timed chain

        def feedback(y):  # (B, N) int32 -> (B, K) int8, data-dependent
            return (y[:, :1] & 1).to(torch.int8) + d0

        dot_ops = 2 * B * K_DOT * P.N
        for tile in int8_gemm.TILES:
            out.append(Case(f"dot tile={tile}",
                            lambda d, tile=tile: feedback(int8_gemm.int8_matmul(d, wt, tile)),
                            d0, dot_ops, "TOPS"))
        out.append(Case("dot torch._int_mm (cuBLASLt)",
                        lambda d: feedback(torch._int_mm(d, wt.t())), d0, dot_ops, "TOPS"))
    return out


def run(B: int = DEFAULT_B, which=DEFAULT_WHICH, steps: int = _timing.STEPS,
        reps: int = _timing.REPS, out=print) -> dict[str, float]:
    """Time ``which`` at batch B on the card; {line name: seconds per step}."""
    device = _timing.require_cuda()
    _timing.header("step breakdown (P6, P7)", B, out)
    return _timing.run_cases(cases(B, which, device), steps, reps, out)


def parse(argv) -> tuple[int, tuple[str, ...]]:
    B = int(argv[0]) if argv else DEFAULT_B
    which = tuple(argv[1:]) or DEFAULT_WHICH
    unknown = sorted(set(which) - set(KNOWN))
    if unknown:
        raise SystemExit(f"unknown variant(s) {', '.join(unknown)}; known: {', '.join(KNOWN)}")
    return B, which


def main(argv=None) -> int:
    B, which = parse(sys.argv[1:] if argv is None else argv)
    run(B, which)
    return 0


if __name__ == "__main__":
    sys.exit(main())
