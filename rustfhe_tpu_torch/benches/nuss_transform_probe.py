"""The transform-domain (Nussbaumer) external product: exact, then its
three matrix stages timed as int8 GEMMs.

Counterpart of ``benches/nuss_transform_probe.py``.  At N = m*r = 32*32
the length-2r block FFT over S = Z[Y]/(Y^32+1) has signed-permutation
twiddles, so it is a +-1 matrix: the forward transform of the 2L digit
planes is one (N, 2N) int8 product, the key is pre-transformed into 64
per-frequency int8 panels (384, 320), and the inverse of the 5 limb planes
of the 2 outputs is one (2N, N) int8 product; the 1/64 scale is an exact
shift at the end (``engine.transform``, the port's copy of the JAX table
builders).

  exactness  the external product of the ``"nuss"`` engine's pipeline at
             B=4 on random rows and digits (numpy seed 11) against the
             oracle (``engine.oracle``), word for word; any device
  stages     on the card, each on the port's int8 GEMM (P9,
             ``int8_gemm.int8_matmul``) beside ``torch._int_mm`` and its
             int8 bound: forward (6B, 1024) x (1024, 2048); pointwise 64 x
             (B, 384) x (384, 320), one GEMM per frequency, whose 320
             columns are zero-padded to P9's 256-column tile (512); inverse
             (10B, 2048) x (2048, 1024); then the stages' total beside
             K1's step at the same B

MACs per gate and step: forward 6*N*2N = 12.58M, pointwise 64*384*320 =
7.86M, inverse 2*5*2N*N = 20.97M: 41.4M against the schoolbook 48M.
Timing: chains between CUDA events (``_timing.chain``); each call's
first FEED input entries are set in place from its output's low bits
(``feed``), so the chain orders the launches at the cost of one tiny copy
and times the GEMMs, not a pass over their outputs.  ``NUSS_EXACT_ONLY`` stops after the check.

Usage: python -m rustfhe_tpu_torch.benches.nuss_transform_probe [B]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import _u32
from ..engine import cmux_k, int8_gemm, oracle
from ..engine.transform import (BLIMBS, NussTransformEngine, forward_matrix, inverse_matrix,
                                split_mr)
from ..params import DEFAULT_PARAMS as P
from . import _timing
from ._timing import Case
from .k2_floor_probe import draw_step, macs

DEFAULT_B = 8192
B_EXACT = 4
N = P.N
TWO_L = 2 * P.l
HALF_BG = P.bg // 2
M, R = split_mr(N)
F2 = 2 * R  # frequencies
PW_K, PW_N = TWO_L * 2 * M, 2 * BLIMBS * M  # the pointwise GEMM: (B, 384) x (384, 320)
FEED = 16  # input entries a chain's next call takes from the previous output


def exactness(device, out=print) -> None:
    """The pipeline's product at B=4 against the oracle; raises on a
    difference."""
    rs = np.random.RandomState(11)
    rows = _u32.from_numpy(rs.randint(0, 2**32, size=(TWO_L, 2, N), dtype=np.uint64), device)
    digits = torch.from_numpy(rs.randint(-HALF_BG, HALF_BG, size=(B_EXACT, TWO_L, N))
                              .astype(np.int32)).to(device)
    eng = NussTransformEngine()
    got = eng.external_product_digits(eng.prepare_trgsw(rows, P), digits, P)
    if not torch.equal(got, oracle.external_product(rows, digits)):
        raise AssertionError("the transform-domain external product differs from the oracle")
    out(f"nussbaumer transform-domain external product exact against the oracle: True "
        f"(B={B_EXACT}, N={N}, on {device})")


def feed(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The next input of a chain: ``x`` with its first FEED entries set, in
    place, from the low bits of ``y``'s first row, so that each GEMM reads
    the previous one's output at the cost of one tiny copy."""
    x.view(-1, x.shape[-1])[0, :FEED] = ((y.reshape(-1, y.shape[-1])[0, :FEED] & 63) - 32).to(
        torch.int8)
    return x


def stage_cases(B: int, device) -> tuple[list, dict]:
    """Each stage on P9 and on ``torch._int_mm`` (weights column-major, as
    cuBLASLt's int8 GEMM takes them); and {stage: int8 ops}."""
    rs = np.random.RandomState(11)
    mf = torch.from_numpy(forward_matrix(N)).to(device)  # (N, 2N)
    mi = torch.from_numpy(inverse_matrix(N)).to(device)  # (2N, N)
    panels = torch.from_numpy(rs.randint(-128, 128, size=(F2, PW_K, PW_N)).astype(np.int8))
    _, bn = int8_gemm.tile_shape(int8_gemm.TILE)
    # (64, 512, 384): P9's layout, the 320 columns zero-padded to its tile
    panels_t = F.pad(panels.transpose(1, 2), (0, 0, 0, -PW_N % bn)).contiguous().to(device)
    mf_t, mi_t = int8_gemm.prepare_rhs(mf), int8_gemm.prepare_rhs(mi)
    d8 = torch.from_numpy(rs.randint(-32, 32, size=(TWO_L * B, N)).astype(np.int8)).to(device)
    dk8 = torch.from_numpy(rs.randint(-32, 32, size=(F2, B, PW_K)).astype(np.int8)).to(device)
    l8 = torch.from_numpy(rs.randint(-128, 128, size=(2 * BLIMBS * B, 2 * N)).astype(np.int8))
    l8 = l8.to(device)

    def chained(gemm):
        return lambda x: feed(x, gemm(x))

    def pointwise(gemm):  # 64 GEMMs, one a frequency, each feeding its own plane
        def step(x):
            firsts = torch.stack([gemm(x[k], k)[0] for k in range(F2)])  # (64, cols)
            x[:, 0, :FEED] = ((firsts[:, :FEED] & 63) - 32).to(torch.int8)
            return x
        return step

    stages = {  # stage: (GEMM shape, first input, P9's step, the library's step, int8 ops)
        "forward": (f"{TWO_L}x(B,{N})@({N},{2 * N})", d8,
                    chained(lambda x: int8_gemm.int8_matmul(x, mf_t)),
                    chained(lambda x: torch._int_mm(x, mf_t.t())), 2.0 * TWO_L * B * N * 2 * N),
        "pointwise": (f"{F2}x(B,{PW_K})@({PW_K},{PW_N})", dk8,
                      pointwise(lambda x, k: int8_gemm.int8_matmul(x, panels_t[k])),
                      pointwise(lambda x, k: torch._int_mm(x, panels_t[k, :PW_N].t())),
                      2.0 * F2 * B * PW_K * PW_N),
        "inverse": (f"{2 * BLIMBS}x(B,{2 * N})@({2 * N},{N})", l8,
                    chained(lambda x: int8_gemm.int8_matmul(x, mi_t)),
                    chained(lambda x: torch._int_mm(x, mi_t.t())),
                    2.0 * 2 * BLIMBS * B * 2 * N * N),
    }
    cases, ops = [], {}
    for stage, (shape, x0, p9, lib, n_ops) in stages.items():
        ops[stage] = n_ops
        bound = _timing.bound(ops=n_ops)[0] / 1e3
        cases.append(Case(f"{stage} {shape} P9", p9, x0, n_ops, "TOPS", bound_s=bound))
        cases.append(Case(f"{stage} torch._int_mm", lib, x0, n_ops, "TOPS", bound_s=bound))
    return cases, ops


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """The exactness check, then the stages and K1's step at batch B on the
    card; {line: seconds per call}."""
    device = _timing.require_cuda()
    _timing.header("transform-domain external product stages", B, out)
    exactness(device, out)
    if os.environ.get("NUSS_EXACT_ONLY"):
        return {}
    cases, ops = stage_cases(B, device)
    times = _timing.run_cases(cases, steps, reps, out)
    _, a_t, _, key, acc = draw_step(np.random.RandomState(7), B, device)
    k1 = _timing.chain(Case("K1 cmux_step (the production step)",
                            lambda a: cmux_k.cmux_step(a, a_t, key, P), acc, 2 * B * macs(P)),
                       steps, reps, out)
    times["K1"] = k1
    total = sum(v for k, v in times.items() if k.endswith("P9"))
    lib = sum(v for k, v in times.items() if k.endswith("_int_mm"))
    out(f"\n# the three stages on P9: {total * 1e3:.3f} ms ({lib * 1e3:.3f} ms on "
        f"torch._int_mm) against K1's whole step {k1 * 1e3:.3f} ms at B={B}; the stages' int8 "
        f"bound {_timing.bound(ops=sum(ops.values()))[0]:.4f} ms")
    return times


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else DEFAULT_B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
