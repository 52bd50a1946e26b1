"""The transform-domain (Nussbaumer / incomplete-NTT) engine ``"nuss"``.

Counterpart of ``rustfhe_tpu/engine/transform.py`` (``NussTransformEngine``),
with its own copy of the numpy table builders (the JAX module imports jax):

* N = m*r (r <= m, powers of two); block i of a polynomial is the stride
  slice x[i::r], an element of S = Z[Y]/(Y^m + 1).  omega = Y^(m/r) is a
  2r-th root of unity in S, and multiplying by a power of omega is a signed
  permutation of a block, so the length-2r block FFT is a +-1 integer
  matrix: forward M_f (N, 2N) over the digits, inverse M_i (2N, N) (with
  the X^r = Y wraparound folded in) over the outputs.
* The key rows are transformed once, host-side in numpy, into per-frequency
  int8 panels (``prepare_panels``), pre-scaled by 2^(6d) for the two digit
  limbs d.  The pipeline runs mod 2^40 (5 signed 8-bit key limbs), and the
  inverse FFT's division by 2r is recovered exactly at the end
  (``abc_combine``).

The transforms and the pointwise contraction are float64 matrix products of
small integers, exact far below 2^53; ``relimb`` and ``abc_combine`` are
the JAX module's wrapping int32 steps, on int64 (every value fits int32,
so the arithmetic shift ``A >> sh`` gives the same bits).

Table preparation builds, per TRGSW, a (2r, 2L*2*m, 2*5*m) int8 panel stack
in Python loops (64 x 384 x 320 at N=1024, seconds each), so, as in the JAX
package, the engine serves direct calls and the oracle probe;
``keys.prepare_cloud_key`` refuses it.  The primitives it is built from on
a TPU (the in-block negacyclic roll and the block butterfly) are the
kernel ``nuss_primitives`` (P10).
"""

from __future__ import annotations

import functools
from typing import ClassVar

import numpy as np
import torch

from .._u32 import to_numpy, wrap
from ..params import TFHEParams

MOD_BITS = 40
MOD = 1 << MOD_BITS
DLIMB_BITS = 6  # digit-transform limb base (values fit int8 after split)
BLIMBS = 5      # key limbs of 8 bits covering mod 2^40


def split_mr(N: int) -> tuple[int, int]:
    """N -> (m, r): r the largest power of two with r <= m and m*r = N."""
    nbit = N.bit_length() - 1
    r = 1 << (nbit // 2)
    return N // r, r


def _rot_np(v, e, m):
    """Y^e * v in S = Z[Y]/(Y^m+1) (numpy, values mod MOD)."""
    e = e % (2 * m)
    u = np.arange(m)
    src = (u - e) % m
    sign = np.where(((u - e) % (2 * m)) >= m, MOD - 1, 1).astype(np.uint64)
    return (v[..., src] * sign) % MOD


@functools.lru_cache(maxsize=8)
def forward_matrix(N: int) -> np.ndarray:
    """M_f (N, 2N) int8 in {-1, 0, 1}: natural-layout polynomial ->
    block-major frequency planes F_k = sum_i omega^(ik) A_i."""
    m, r = split_mr(N)
    w = m // r  # omega = Y^w
    Mf = np.zeros((N, 2 * N), np.int8)
    uu = np.arange(m)
    for i in range(r):
        for k in range(2 * r):
            e = (w * i * k) % (2 * m)
            src = (uu - e) % m
            sg = np.where(((uu - e) % (2 * m)) >= m, -1, 1)
            Mf[i + src * r, k * m + uu] += sg.astype(np.int8)
    return Mf


@functools.lru_cache(maxsize=8)
def inverse_matrix(N: int) -> np.ndarray:
    """M_i (2N, N) int8: frequency planes -> natural-layout coefficients,
    the inverse FFT without its 1/2r scale, the X^r = Y wraparound folded in."""
    m, r = split_mr(N)
    w = m // r
    Mi = np.zeros((2 * N, N), np.int64)
    uu = np.arange(m)
    for k in range(2 * r):
        for t in range(2 * r):
            e = (-w * t * k) % (2 * m)
            if t >= r:
                tt, e = t - r, (e + 1) % (2 * m)  # wraparound: Y * C_t
            else:
                tt = t
            src = (uu - e) % m
            sg = np.where(((uu - e) % (2 * m)) >= m, -1, 1)
            Mi[k * m + src, tt + uu * r] += sg
    if np.abs(Mi).max() > 2:
        raise AssertionError("inverse transform entries exceed 2")
    return Mi.astype(np.int8)


def _bal_split_np(x, width, n_limbs):
    out = []
    v = x.astype(np.int64).copy()
    for _ in range(n_limbs):
        limb = v - (((v + (1 << (width - 1))) >> width) << width)
        out.append(limb)
        v = (v - limb) >> width
    return out


def prepare_panels(rows_u32: np.ndarray, N: int) -> np.ndarray:
    """rows (2L, 2, N) uint32 -> per-frequency pointwise panels int8
    (2r, 2L*2*m, 2*BLIMBS*m): row (j, d, u) holds the limb columns of
    Y^u * (2^(6d) * G[j, c, k]) mod 2^40."""
    m, r = split_mr(N)
    w = m // r
    two_l = rows_u32.shape[0]
    q = np.asarray(rows_u32, np.uint64)
    G = np.zeros((two_l, 2, 2 * r, m), np.uint64)
    blocks = q.reshape(two_l, 2, m, r)  # [..., u, i]: A_i[u] = x[i + u*r]
    for k in range(2 * r):
        acc = np.zeros((two_l, 2, m), np.uint64)
        for i in range(r):
            acc = (acc + _rot_np(blocks[..., i], w * i * k, m)) % MOD
        G[:, :, k, :] = acc
    panels = np.zeros((2 * r, two_l * 2 * m, 2 * BLIMBS * m), np.int8)
    for k in range(2 * r):
        for j in range(two_l):
            for d in range(2):
                scaled = (G[j, :, k] << np.uint64(DLIMB_BITS * d)) % MOD
                for c in range(2):
                    for u in range(m):
                        gy = _rot_np(scaled[c], u, m).astype(np.int64) % MOD
                        gl = _bal_split_np(gy, 8, BLIMBS)
                        row = (j * 2 + d) * m + u
                        for e in range(BLIMBS):
                            panels[k, row, (c * BLIMBS + e) * m:
                                   (c * BLIMBS + e + 1) * m] = gl[e]
    return panels


# --------------------------------------------------------------------- #
# The exact pipeline
# --------------------------------------------------------------------- #
def _exact_f64(x: torch.Tensor) -> torch.Tensor:
    return x.round().to(torch.int64)


def dlimb_split(F: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Balanced base-2^6 split of transform values: F == f0 + f1 * 2^6."""
    f1 = (F + (1 << (DLIMB_BITS - 1))) >> DLIMB_BITS
    return F - (f1 << DLIMB_BITS), f1


def forward_digits(digits: torch.Tensor, N: int):
    """digits (..., 2L, N) -> (f0, f1), each int64 (..., 2L, 2N)."""
    Mf = torch.from_numpy(forward_matrix(N)).to(device=digits.device, dtype=torch.float64)
    return dlimb_split(_exact_f64(digits.to(torch.float64) @ Mf))


def pointwise(f0: torch.Tensor, f1: torch.Tensor, panels: torch.Tensor, m: int) -> torch.Tensor:
    """Per-frequency contraction: f0/f1 (..., 2L, n_freq*m), panels
    (n_freq, 2L*2*m, 2*BLIMBS*m) -> int64 (..., 2, BLIMBS, n_freq*m)."""
    n_freq = panels.shape[-3]
    two_l = f0.shape[-2]
    lead = f0.shape[:-2]
    fk = torch.stack([f0, f1], dim=-2).reshape(lead + (two_l * 2, n_freq, m))
    fk = fk.transpose(-3, -2).reshape(lead + (n_freq, 1, two_l * 2 * m))
    out = _exact_f64(fk.to(torch.float64) @ panels.to(torch.float64))  # (..., n_freq, 1, C)
    out = out.reshape(lead + (n_freq, 2, BLIMBS, m)).movedim(-4, -2)
    return out.reshape(lead + (2, BLIMBS, n_freq * m))


def relimb(parts: torch.Tensor) -> torch.Tensor:
    """Canonical re-limb of sum_e parts_e 2^(8e) mod 2^40 into BLIMBS planes
    in [-128, 128)."""
    limbs = []
    carry = torch.zeros_like(parts[..., 0, :])
    for e in range(BLIMBS):
        t = parts[..., e, :] + carry
        limb = t - (((t + 128) >> 8) << 8)
        limbs.append(limb)
        carry = (t - limb) >> 8
    return torch.stack(limbs, dim=-2)


def abc_combine(W: torch.Tensor, sh: int) -> torch.Tensor:
    """Exact division by 2^sh mod 2^32 of the BLIMBS inverse-transform
    planes W (..., BLIMBS, n): S = A + B*2^16 + C*2^32 with 2^sh | A, so
    c = (A >> sh) + (B << (16-sh)) + (C << (32-sh)); int32 (..., n)."""
    A = W[..., 0, :] + (W[..., 1, :] << 8)
    B = W[..., 2, :] + (W[..., 3, :] << 8)
    C = W[..., 4, :]
    return wrap((A >> sh) + (B << (16 - sh)) + (C << (32 - sh)))


def inverse_combine(limbs: torch.Tensor, N: int) -> torch.Tensor:
    """limbs (..., BLIMBS, 2N) -> int32 (..., N)."""
    _, r = split_mr(N)
    sh = (2 * r).bit_length() - 1
    Mi = torch.from_numpy(inverse_matrix(N)).to(device=limbs.device, dtype=torch.float64)
    return abc_combine(_exact_f64(limbs.to(torch.float64) @ Mi), sh)


class NussTransformEngine:
    """The external product in the transform domain, exact mod 2^32."""

    name: ClassVar[str] = "nuss"

    def prepare_trgsw(self, rows: torch.Tensor, params: TFHEParams) -> torch.Tensor:
        """TRGSW rows int32 ``(..., 2L, 2, N)`` -> panels int8
        ``(..., 2r, 2L*2*m, 2*5*m)``, built host-side."""
        rows_np = to_numpy(rows)
        lead = rows_np.shape[:-3]
        flat = rows_np.reshape((-1,) + rows_np.shape[-3:])
        panels = np.stack([prepare_panels(f, params.N) for f in flat])
        return torch.from_numpy(panels.reshape(lead + panels.shape[1:])).to(rows.device)

    def external_product_digits(self, prepared: torch.Tensor, digits: torch.Tensor,
                                params: TFHEParams) -> torch.Tensor:
        """``prepared`` panels; ``digits`` integers ``(..., 2L, N)`` ->
        int32 ``(..., 2, N)``."""
        N = params.N
        m, _ = split_mr(N)
        f0, f1 = forward_digits(digits, N)
        return inverse_combine(relimb(pointwise(f0, f1, prepared, m)), N)

    def poly_mul_torus_binary(self, a: torch.Tensor, s: torch.Tensor,
                              params: TFHEParams | None = None) -> torch.Tensor:
        from .matmul import MatmulEngine

        return MatmulEngine().poly_mul_torus_binary(a, s, params)


__all__ = ["NussTransformEngine", "forward_matrix", "inverse_matrix", "prepare_panels",
           "split_mr"]
