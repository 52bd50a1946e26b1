"""Negacyclic polynomial operations over Z[X]/(X^N + 1), batched.

Counterpart of ``rustfhe_tpu/poly.py``.  Polynomials are tensors whose last
axis holds the N coefficients; torus polynomials are int32 words.

  * ``rotate``: multiplication by X^n with the negacyclic sign wrap, as a
    gather on the index reduced mod 2N (a gather is cheap on a GPU; the
    JAX package avoided it only for the TPU's scalar core).
  * ``rotate_binary``: the same result from log2(2N) static rolls, the
    JAX package's gather-free form, kept for parity.
  * ``negacyclic_mul_torus_oracle``: naive O(N^2) product mod 2^32, the
    ground truth every fast path is held to.
  * ``negacyclic_mul_i64``: the exact product over the integers, host
    numpy (an oracle for tests).
  * ``to_signed_limbs`` / ``from_signed_limbs``: balanced signed limb
    split of 32-bit words and its recombination.
"""

from __future__ import annotations

import numpy as np
import torch

from ._u32 import as_u32_int64, srl, wrap


def rotate(p: torch.Tensor, n, two_n: int | None = None) -> torch.Tensor:
    """Multiply polynomial(s) ``p (..., N)`` by X^n in Z[X]/(X^N + 1).

    ``n`` is a Python int or an integer tensor broadcastable to
    ``p.shape[:-1]`` (one rotation per batch item).  With
    m = n mod 2N: out[i] = p[k], k = (i - m) mod 2N, negated when k >= N.
    """
    N = p.shape[-1]
    tn = two_n if two_n is not None else 2 * N
    n = torch.as_tensor(n, dtype=torch.int64, device=p.device)
    idx = torch.arange(N, dtype=torch.int64, device=p.device)
    k = torch.remainder(idx - n[..., None], tn)
    neg = k >= N
    k = torch.where(neg, k - N, k)
    shape = torch.broadcast_shapes(p.shape, k.shape)
    gathered = torch.gather(p.expand(shape), -1, k.expand(shape))
    return torch.where(neg.expand(shape), -gathered, gathered)


def _negacyclic_roll_static(p: torch.Tensor, s: int) -> torch.Tensor:
    """Multiply by X^s for a static s: slice, concatenate, negate."""
    N = p.shape[-1]
    s = s % (2 * N)
    neg = s >= N
    if neg:
        s -= N
    out = p if s == 0 else torch.cat([-p[..., N - s:], p[..., : N - s]], dim=-1)
    return -out if neg else out


def rotate_binary(p: torch.Tensor, n, nbits: int | None = None) -> torch.Tensor:
    """``rotate`` by the binary digits of ``n`` (already reduced to [0, 2N)):
    one static roll and select per bit.  ``n`` broadcasts to ``p.shape[:-1]``."""
    N = p.shape[-1]
    if nbits is None:
        nbits = (2 * N - 1).bit_length()
    n = torch.as_tensor(n, dtype=torch.int64, device=p.device)
    out = p
    for k in range(nbits):
        bit = ((n >> k) & 1).to(torch.bool)[..., None]
        out = torch.where(bit, _negacyclic_roll_static(out, 1 << k), out)
    return out


def negacyclic_mul_torus_oracle(a_torus: torch.Tensor, b_int: torch.Tensor,
                                chunk: int = 128) -> torch.Tensor:
    """Exact negacyclic product of torus poly(s) by integer poly(s), mod 2^32.

    ``a_torus`` int32 words ``(..., N)``; ``b_int`` integers ``(..., N)``
    (|b| <= 2^31); the two broadcast.  Each product of a word read unsigned
    (< 2^32) with |b| <= 2^31 fits int64 and is reduced mod 2^32 before the
    sum, so the sum of N terms stays below 2^43: exact for any operands.
    out[k] = sum_i a[i] * d[(k - i) mod 2N] with d = [b, -b].  Output
    coefficients are taken ``chunk`` at a time to bound the (.., chunk, N)
    int64 intermediate.
    """
    a = as_u32_int64(a_torus)
    b = b_int.to(torch.int64)
    N = a.shape[-1]
    d = torch.cat([b, -b], dim=-1)
    i = torch.arange(N, device=a.device)
    outs = []
    for k0 in range(0, N, chunk):
        k = torch.arange(k0, min(k0 + chunk, N), device=a.device)
        idx = torch.remainder(k[:, None] - i[None, :], 2 * N)  # (chunk, N)
        mat = d[..., idx]  # (..., chunk, N)
        prod = (a[..., None, :] * mat) & 0xFFFFFFFF
        outs.append(prod.sum(dim=-1))
    return wrap(torch.cat(outs, dim=-1))


def negacyclic_mul_i64(a, b) -> np.ndarray:
    """Exact negacyclic product over the integers (int64, host numpy):
    out[k] = sum_i a_i * d[(k - i) mod 2N] with d = [b, -b].  O(N^2), for
    tests only."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    N = a.shape[-1]
    d = np.concatenate([b, -b], axis=-1)
    k = np.arange(N)
    idx = np.mod(k[:, None] - k[None, :], 2 * N)  # (N out, N in)
    return np.einsum("...i,...ki->...k", a, d[..., idx])


def to_signed_limbs(x: torch.Tensor, limb_bits: int, num_limbs: int,
                    dtype=torch.int8) -> torch.Tensor:
    """Split 32-bit words into balanced signed limbs ``(..., num_limbs)``.

    Limb k lies in [-2^(limb_bits-1), 2^(limb_bits-1)) and
    ``sum_k limb_k * 2^(limb_bits*k) == x (mod 2^32)``; the carry out of the
    top limb has weight >= 2^32 and is dropped.
    """
    if limb_bits * num_limbs < 32:
        raise ValueError("limbs must cover 32 bits")
    base = (1 << limb_bits) - 1
    half = 1 << (limb_bits - 1)
    limbs = []
    carry = torch.zeros_like(x)
    for k in range(num_limbs):
        shift = limb_bits * k
        raw = (srl(x, shift) & base) if shift < 32 else torch.zeros_like(x)
        raw = raw + carry
        over = raw >= half
        limbs.append((raw - over.to(x.dtype) * (1 << limb_bits)).to(dtype))
        carry = over.to(x.dtype)
    return torch.stack(limbs, dim=-1)


def from_signed_limbs(limbs: torch.Tensor, limb_bits: int) -> torch.Tensor:
    """Recombine limbs ``(..., num_limbs)``: sum_k limb_k << (limb_bits*k)
    mod 2^32, as int32 words (a test helper)."""
    num = limbs.shape[-1]
    weights = torch.tensor([(1 << (limb_bits * k)) & 0xFFFFFFFF if limb_bits * k < 32 else 0
                            for k in range(num)], dtype=torch.int64, device=limbs.device)
    return wrap((limbs.to(torch.int64) * weights).sum(dim=-1))
