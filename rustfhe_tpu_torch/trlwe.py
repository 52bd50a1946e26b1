"""TRLWE (ring LWE over the torus), batched.

Counterpart of ``rustfhe_tpu/trlwe.py``: a batch of TRLWE ciphertexts is
one int32 tensor ``(..., 2, N)``, index 0 the body polynomial ``b`` and
index 1 the mask ``a``.  The body is computed exactly
(``b = a (*) s + m + e``) by ``engine.plain.poly_mul_torus_binary``.
"""

from __future__ import annotations

import torch

from . import torus
from .engine.plain import poly_mul_torus_binary
from .params import TFHEParams
from .utils.rng import gaussian_torus, uniform_torus


def trivial(msg: torch.Tensor) -> torch.Tensor:
    """Noiseless ciphertext (m, 0); msg (..., N)."""
    return torch.stack([msg, torch.zeros_like(msg)], dim=-2)


def encrypt_torus_poly(gen: torch.Generator, s: torch.Tensor, m: torch.Tensor,
                       params: TFHEParams) -> torch.Tensor:
    """Encrypt torus polynomial(s) ``m (..., N)`` under binary poly key ``s (N,)``."""
    a = uniform_torus(gen, m.shape, s.device)
    e = gaussian_torus(gen, m.shape, params.alpha_lv1, s.device)
    b = poly_mul_torus_binary(a, s) + m + e
    return torch.stack([b, a], dim=-2)


def phase(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """b - a (*) s; ct (..., 2, N) -> (..., N)."""
    return ct[..., 0, :] - poly_mul_torus_binary(ct[..., 1, :], s)


def encrypt_binary_poly(gen: torch.Generator, s: torch.Tensor, bits: torch.Tensor,
                        params: TFHEParams) -> torch.Tensor:
    """bits (..., N) in {0,1} -> TRLWE of the +-1/8 encoding."""
    return encrypt_torus_poly(gen, s, torus.binary_to_torus(bits), params)


def decrypt_binary_poly(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torus.torus_to_binary(phase(ct, s))


def sample_extract(ct: torch.Tensor, index: int) -> torch.Tensor:
    """TLWE ciphertext of coefficient ``index``: ct (..., 2, N) -> (..., N+1),
    b' = b[index]; a'_i = a[index - i] for i <= index, else -a[N + index - i]."""
    N = ct.shape[-1]
    k = torch.remainder(index - torch.arange(N, device=ct.device), 2 * N)
    neg = k >= N
    k = torch.where(neg, k - N, k)
    gathered = ct[..., 1, :][..., k]
    a_prime = torch.where(neg, -gathered, gathered)
    return torch.cat([ct[..., 0, index:index + 1], a_prime], dim=-1)
