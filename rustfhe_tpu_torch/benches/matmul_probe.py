"""The blocked int8 GEMM at the external product's shape, on the card (P9).

Counterpart of ``benches/pallas_matmul_probe.py``: (B, 6144) @ (6144,
8192) -> int32, the hand-written tensor-core kernel
(``int8_gemm.int8_matmul``) at each tile of ``int8_gemm.TILES`` against
the library yardstick ``torch._int_mm`` (cuBLASLt int8; the JAX probe's
reference line was XLA's ``jnp.dot``), on a data-dependent chain (each
product's low bits feed the next left operand, as the JAX probe does).
Same inputs (numpy seed 0) and rate (2*B*K*N per step) as the JAX probe;
its 8 chained calls become STEPS x REPS.

Usage: python -m rustfhe_tpu_torch.benches.matmul_probe [B]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..engine import int8_gemm
from . import _timing
from ._timing import Case

DEFAULT_B = 4096
K, N = 6144, 8192


def operands(B: int, device):
    """c8 (K, N) and d0 (B, K), as the JAX probe draws them."""
    rs = np.random.RandomState(0)
    c8 = torch.from_numpy(rs.randint(-128, 128, size=(K, N)).astype(np.int8)).to(device)
    d0 = torch.from_numpy(rs.randint(-32, 32, size=(B, K)).astype(np.int8)).to(device)
    return c8, d0


def feedback(y: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 -> (B, K) int8, keeping the chain data-dependent."""
    return ((y[:, :K] & 63) - 32).to(torch.int8)


def cases(B: int, device) -> list:
    c8, d0 = operands(B, device)
    ct = int8_gemm.prepare_rhs(c8)  # once, outside the timed chain
    ops = 2 * B * K * N
    out = [Case("torch._int_mm int8 (cuBLASLt)", lambda d: feedback(torch._int_mm(d, ct.t())),
                d0, ops, "TOPS")]
    for tile in int8_gemm.TILES:
        out.append(Case(f"int8_gemm tile={tile}",
                        lambda d, tile=tile: feedback(int8_gemm.int8_matmul(d, ct, tile)),
                        d0, ops, "TOPS"))
    return out


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """Time the GEMM at batch B on the card; {line name: seconds per step}."""
    device = _timing.require_cuda()
    _timing.header("int8 GEMM (P9)", B, out)
    return _timing.run_cases(cases(B, device), steps, reps, out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else DEFAULT_B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
