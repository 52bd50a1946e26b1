"""TRGSW: gadget-decomposed ring-GSW ciphertexts, batched.

Counterpart of ``rustfhe_tpu/trgsw.py``.  A TRGSW ciphertext is int32
``(..., 2L, 2, N)``: 2L zero-encryptions with the gadget added, row j < L
carrying m/Bg^(j+1) on the body, row L+j on the mask.  The external
product takes the prepared (doubled) rows of
``engine.plain.prepare_trgsw`` and runs through the K2 wrapper of
``engine.cmux_k``.
"""

from __future__ import annotations

import torch

from .decomp import decompose_signed
from .engine import cmux_k
from .engine.plain import poly_mul_torus_binary
from .params import TFHEParams
from .utils.rng import gaussian_torus, uniform_torus


def encrypt_int(gen: torch.Generator, s: torch.Tensor, item: torch.Tensor,
                params: TFHEParams) -> torch.Tensor:
    """Encrypt scalar integer(s) ``item (...,)`` on the constant term under
    the binary poly key ``s (N,)``.  Returns ``(..., 2L, 2, N)``."""
    shape = tuple(item.shape) + (2 * params.l, params.N)
    a = uniform_torus(gen, shape, s.device)
    e = gaussian_torus(gen, shape, params.alpha_lv1, s.device)
    b = poly_mul_torus_binary(a, s) + e
    rows = torch.stack([b, a], dim=-2)
    l = params.l
    item = item.to(torch.int32)
    for j in range(l):
        g = item << (32 - params.bgbit * (j + 1))
        rows[..., j, 0, 0] += g
        rows[..., l + j, 1, 0] += g
    return rows


def decompose_trlwe(ct: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Gadget-decompose TRLWE pair(s) (..., 2, N) into int32 (..., 2L, N):
    body digits, then mask digits."""
    digits = decompose_signed(ct, params).movedim(-1, -2)  # (..., 2, L, N)
    return digits.reshape(ct.shape[:-2] + (2 * params.l, params.N))


def external_product(prepared: torch.Tensor, ct: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """Prepared TRGSW (2L, 2, 2N) x TRLWE (B, 2, N) -> TRLWE (B, 2, N)."""
    digits = decompose_trlwe(ct, params).to(torch.int8).contiguous()
    return cmux_k.external_product(digits, prepared, params)


def cmux(prepared: torch.Tensor, ct1: torch.Tensor, ct0: torch.Tensor,
         params: TFHEParams) -> torch.Tensor:
    """TRGSW(bit).cmux(ct1, ct0) = ExtProd(ct1 - ct0) + ct0."""
    return ct0 + external_product(prepared, ct1 - ct0, params)

