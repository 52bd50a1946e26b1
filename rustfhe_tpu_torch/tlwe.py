"""TLWE (scalar LWE over the torus), batched.

Counterpart of ``rustfhe_tpu/tlwe.py``: a batch of TLWE ciphertexts is one
int32 tensor ``(..., n+1)`` with the body ``b`` at index 0 and the mask
``a`` at 1..n.  Encoding: One -> +1/8, Zero -> -1/8.
"""

from __future__ import annotations

import torch

from . import torus
from ._u32 import s32, wrap
from .params import TFHEParams
from .utils.rng import gaussian_torus, uniform_torus


def trivial(b: torch.Tensor, n: int) -> torch.Tensor:
    """Noiseless ciphertexts (b, 0, ..., 0)."""
    out = torch.zeros(b.shape + (n + 1,), dtype=torch.int32, device=b.device)
    out[..., 0] = b
    return out


def logic_true(n: int, device) -> torch.Tensor:
    """The noiseless ciphertext of One (+1/8), (n+1,) on ``device``."""
    return trivial(torch.tensor(torus.TORUS_ONE_EIGHTH, dtype=torch.int32, device=device), n)


def logic_false(n: int, device) -> torch.Tensor:
    """The noiseless ciphertext of Zero (-1/8), (n+1,) on ``device``."""
    return trivial(torch.tensor(torus.TORUS_MINUS_ONE_EIGHTH, dtype=torch.int32,
                                device=device), n)


def body(ct: torch.Tensor) -> torch.Tensor:
    return ct[..., 0]


def mask(ct: torch.Tensor) -> torch.Tensor:
    return ct[..., 1:]


def neg(ct: torch.Tensor) -> torch.Tensor:
    return -ct


def mul_int(ct: torch.Tensor, k: int) -> torch.Tensor:
    """Scalar multiple k * ct, wrapping mod 2^32; any Python int k."""
    return ct * s32(k)


def _dot_key(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^32 for masks ``a (..., n)`` and the binary key ``s (n,)``
    (int64 sum of at most n words: exact)."""
    return wrap((a.to(torch.int64) * s.to(torch.int64)).sum(dim=-1))


def encrypt_torus(gen: torch.Generator, s: torch.Tensor, m: torch.Tensor,
                  params: TFHEParams) -> torch.Tensor:
    """Encrypt torus message(s) ``m`` (int32, any shape) under the binary
    key ``s (n,)``: b = <a, s> + e + m."""
    n = s.shape[-1]
    a = uniform_torus(gen, m.shape + (n,), s.device)
    e = gaussian_torus(gen, m.shape, params.alpha_lv0, s.device)
    b = _dot_key(a, s) + e + m
    return torch.cat([b[..., None], a], dim=-1)


def phase(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """b - <a, s>."""
    return ct[..., 0] - _dot_key(ct[..., 1:], s)


def encrypt_binary(gen: torch.Generator, s: torch.Tensor, bits: torch.Tensor,
                   params: TFHEParams) -> torch.Tensor:
    return encrypt_torus(gen, s, torus.binary_to_torus(bits), params)


def decrypt_binary(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torus.torus_to_binary(phase(ct, s))
