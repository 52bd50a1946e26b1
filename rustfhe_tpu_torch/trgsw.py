"""TRGSW: gadget-decomposed ring-GSW ciphertexts, batched.

Counterpart of ``rustfhe_tpu/trgsw.py``.  A TRGSW ciphertext is int32
``(..., 2L, 2, N)``: 2L zero-encryptions with the gadget added, row j < L
carrying m/Bg^(j+1) on the body, row L+j on the mask.  The external
product takes the prepared (doubled) rows of
``engine.plain.prepare_trgsw`` and runs through the K2 wrapper of
``engine.cmux_k``.  Encryption and decryption of integer, uint and binary
items, scalar or polynomial, follow the JAX module; decryption reads row 0
and rounds its phase to a gadget digit.
"""

from __future__ import annotations

import torch

from . import tlwe, trlwe
from ._u32 import srl
from .decomp import decompose_trlwe
from .engine import cmux_k
from .engine.plain import poly_mul_torus_binary
from .params import TFHEParams
from .utils.rng import gaussian_torus, uniform_torus


def encrypt_int_poly(gen: torch.Generator, s: torch.Tensor, item: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """Encrypt integer polynomial(s) ``item (..., N)`` under the binary poly
    key ``s (N,)``: 2L zero-encryptions, row j < L carrying
    item * 2^(32 - bgbit*(j+1)) on the body, row L+j on the mask.  Returns
    ``(..., 2L, 2, N)``."""
    shape = tuple(item.shape[:-1]) + (2 * params.l, params.N)
    a = uniform_torus(gen, shape, s.device)
    e = gaussian_torus(gen, shape, params.alpha_lv1, s.device)
    b = poly_mul_torus_binary(a, s) + e
    rows = torch.stack([b, a], dim=-2)
    l = params.l
    item = item.to(torch.int32)
    for j in range(l):
        g = item << (32 - params.bgbit * (j + 1))
        rows[..., j, 0, :] += g
        rows[..., l + j, 1, :] += g
    return rows


def encrypt_int(gen: torch.Generator, s: torch.Tensor, item: torch.Tensor,
                params: TFHEParams) -> torch.Tensor:
    """Encrypt scalar integer(s) ``item (...,)`` on the constant term.
    Returns ``(..., 2L, 2, N)``."""
    poly = torch.zeros(tuple(item.shape) + (params.N,), dtype=torch.int32, device=item.device)
    poly[..., 0] = item
    return encrypt_int_poly(gen, s, poly, params)


def _round_phase_to_digit(ph: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """round(phase * Bg) in exact integer arithmetic: the phase encodes
    m * 2^(32 - bgbit), so m = (ph + 2^(31 - bgbit)) >> (32 - bgbit)
    (round half up), mapped to the balanced range (-Bg/2, Bg/2]."""
    bg = params.bg
    shift = 32 - params.bgbit
    m = srl(ph + (1 << (shift - 1)), shift) & (bg - 1)
    return torch.where(m > bg // 2, m - bg, m)


def decrypt_int_poly(rep: torch.Tensor, s: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Read row 0 as a TRLWE of m/Bg and round: (..., 2L, 2, N) -> (..., N)."""
    return _round_phase_to_digit(trlwe.phase(rep[..., 0, :, :], s), params)


def decrypt_int(rep: torch.Tensor, s: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Scalar decrypt through the sample extract of row 0 (its constant
    term); ``s`` is the binary poly key (N,)."""
    t = trlwe.sample_extract(rep[..., 0, :, :], 0)
    return _round_phase_to_digit(tlwe.phase(t, s), params)


def encrypt_uint_poly(gen: torch.Generator, s: torch.Tensor, item: torch.Tensor,
                      params: TFHEParams) -> torch.Tensor:
    """Polynomial of uint32 words (int32 tensors with their bits): as int32."""
    return encrypt_int_poly(gen, s, item, params)


def decrypt_uint_poly(rep: torch.Tensor, s: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """The digits as uint32 words (int32 with the same bits, the port's
    convention): the same tensor as ``decrypt_int_poly``."""
    return decrypt_int_poly(rep, s, params)


def encrypt_binary_poly(gen: torch.Generator, s: torch.Tensor, bits: torch.Tensor,
                        params: TFHEParams) -> torch.Tensor:
    return encrypt_int_poly(gen, s, bits, params)


def decrypt_binary_poly(rep: torch.Tensor, s: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    return (decrypt_int_poly(rep, s, params) != 0).to(torch.int32)


def encrypt_binary(gen: torch.Generator, s: torch.Tensor, bit: torch.Tensor,
                   params: TFHEParams) -> torch.Tensor:
    return encrypt_int(gen, s, bit, params)


def decrypt_binary(rep: torch.Tensor, s: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    return (decrypt_int(rep, s, params) != 0).to(torch.int32)


def external_product(prepared: torch.Tensor, ct: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """Prepared TRGSW (2L, 2, 2N) x TRLWE (B, 2, N) -> TRLWE (B, 2, N)."""
    digits = decompose_trlwe(ct, params).to(torch.int8).contiguous()
    return cmux_k.external_product(digits, prepared, params)


def cmux(prepared: torch.Tensor, ct1: torch.Tensor, ct0: torch.Tensor,
         params: TFHEParams) -> torch.Tensor:
    """TRGSW(bit).cmux(ct1, ct0) = ExtProd(ct1 - ct0) + ct0."""
    return ct0 + external_product(prepared, ct1 - ct0, params)

