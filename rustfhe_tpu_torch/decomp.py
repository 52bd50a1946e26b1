"""Gadget decomposition of Torus32 words, on int32 tensors.

Counterpart of ``rustfhe_tpu/decomp.py``, bit for bit:

* signed base-2^bits decomposition with the rounding-carry mask, digits in
  [-2^(bits-1), 2^(bits-1)), most significant first.  ``decompose_signed``
  uses the production (quirky) mask of ``params._make_decomp_mask``;
  ``make_decomp_mask_inline`` is the textbook variant that the reference's
  own unit vectors exercise.
* unsigned decomposition with simple rounding, used by the key switch.

``>>`` on int32 is arithmetic; each digit is masked to ``bits`` bits right
after its shift, and ``32 - shift >= bits`` for every level, so the mask
keeps only bits that a logical shift would have produced too.
"""

from __future__ import annotations

import torch

from ._u32 import s32, wrap
from .params import TFHEParams, _make_decomp_mask, iks_round_constant

make_decomp_mask = _make_decomp_mask  # the JAX package's name for the production mask


def make_decomp_mask_inline(l: int, bits: int) -> int:
    """The inlined mask of the reference's ``decomposition_i32``."""
    total = 32
    m = 0
    top = l + 1 if total - l * bits != 0 else l
    for i in range(1, top):
        m |= 1 << (total - i * bits - 1)
    return m & 0xFFFFFFFF


def _shifts(bits: int, l: int, device) -> torch.Tensor:
    return torch.tensor([32 - bits * (i + 1) for i in range(l)], dtype=torch.int32,
                        device=device)


def decompose_signed_custom(x: torch.Tensor, bits: int, l: int, mask: int) -> torch.Tensor:
    """Signed decomposition with an explicit rounding mask.

    ``(...,)`` int32 words -> int32 ``(..., l)`` digits:
    ``u = (x + mask) ^ mask``; digit_i = sign-extended
    ``(u >> (32 - bits*(i+1))) & (2^bits - 1)``.
    """
    m = s32(mask)
    half = 1 << (bits - 1)
    u = (x + m) ^ m
    raw = (u[..., None] >> _shifts(bits, l, x.device)) & ((1 << bits) - 1)
    return raw - 2 * (raw & half)


def decompose_signed(x: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Production signed gadget decomposition: (...,) -> (..., l) int32."""
    return decompose_signed_custom(x, params.bgbit, params.l, params.decomp_mask)


def decompose_unsigned_custom(x: torch.Tensor, bits: int, l: int) -> torch.Tensor:
    """Unsigned decomposition with rounding: (...,) -> (..., l) int32 in [0, 2^bits)."""
    u = x + s32(iks_round_constant(bits, l))
    return (u[..., None] >> _shifts(bits, l, x.device)) & ((1 << bits) - 1)


def decompose_unsigned(x: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Key-switch decomposition: (...,) -> (..., iks_l) int32."""
    return decompose_unsigned_custom(x, params.iks_basebit, params.iks_l)



def decompose_trlwe(ct: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Gadget-decompose TRLWE pair(s) (..., 2, N) into int32 (..., 2L, N):
    body digits, then mask digits."""
    digits = decompose_signed(ct, params).movedim(-1, -2)  # (..., 2, L, N)
    return digits.reshape(ct.shape[:-2] + (2 * params.l, params.N))


def recompose_signed(digits: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """sum_i d_i * 2^(32 - bits*(i+1)) mod 2^32 over the last axis: the
    inverse of ``decompose_signed`` up to its rounding (a test helper)."""
    bits = params.bgbit
    weights = torch.tensor([(1 << (32 - bits * (i + 1))) & 0xFFFFFFFF for i in range(params.l)],
                           dtype=torch.int64, device=digits.device)
    return wrap((digits.to(torch.int64) * weights).sum(dim=-1))
