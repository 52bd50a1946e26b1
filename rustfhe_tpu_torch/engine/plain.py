"""Plain torch versions of the kernels' products, and the key switch.

The float64 products the kernels are held to (the JAX package's dense
engine, ``rustfhe_tpu/engine/matmul.py``, has its own counterpart in
``engine/matmul.py``).  Every product here is a
float64 matrix product of small integers against 32-bit key words, with
every partial sum an integer below 2^53, so float64 carries it exactly in
any summation order; the result is reduced mod 2^32 (``_u32.wrap``).  TF32
settings apply to float32 only and do not touch these products.

* ``external_product``: the plain version of the external product that the
  kernels of ``engine/cmux_k.py`` compute, against the prepared (doubled)
  TRGSW table of ``prepare_trgsw``.
* ``external_product_limbs``: the same product in limb form, the plain
  version of what the kernels of ``engine/limb_step.py`` compute, against
  the doubled int8 limb table of ``prepare_trgsw_limbs``
  (``limb_table_from_qd`` takes the JAX package's layout of that table).
* ``cmux_step``: the plain blind-rotate CMux step, acc + product(digits of
  X^{a~} * acc - acc) (``step_digits``), on any of those products.
* ``poly_mul_torus_binary``: torus poly times binary poly (encryption,
  phase, keygen).
* ``prepare_ksk`` / ``key_switch_digits``: the identity key switch as one
  mask product per digit value.  The JAX package runs it as plain XLA, not
  Pallas, so it stays torch ops on the card too.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import poly
from .._u32 import wrap
from ..decomp import decompose_trlwe
from ..params import TFHEParams
from ..poly import to_signed_limbs

# The limb form: every key word as K=4 balanced signed 8-bit limbs.
NUM_LIMBS = 4
LIMB_BITS = 8


def prepare_trgsw(rows: torch.Tensor) -> torch.Tensor:
    """TRGSW rows ``(..., 2L, 2, N)`` int32 -> doubled table
    ``(..., 2L, 2, 2N)`` int32, ``T = [-q, q]`` per row polynomial q.

    The negacyclic product out[k] = sum_i d[i] * q[(k - i) mod^- N] reads
    ``T[k - i + N]`` for every k, i in [0, N): k >= i lands in the upper
    half (q[k - i]), k < i in the lower half (-q[k - i + N]).  No index
    needs a reduction, and no sign is applied in the inner loop.
    """
    return torch.cat([-rows, rows], dim=-1).contiguous()


def circulant_product(d: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``d.reshape(B, 2L*N) @ C`` for digits ``d (B, 2L, N)`` and the
    circulant C[(j, i), (c, k)] = T[j, c, k - i + N] of the doubled table
    ``(2L, H, 2N)`` (H output polynomials, 2 for the two halves): float64
    ``(B, H*N)``, with one copy of the table: T[k - i + N] = T[1 + i' + k]
    for i' = N - 1 - i, so the windows of T[1:] (a view) serve as the
    matrix against the digits reversed along i."""
    two_l, halves, tn = table.shape
    N = tn // 2
    circ = table[..., 1:].to(torch.float64).unfold(-1, N, 1)  # (2L, H, i', k)
    circ = circ.permute(0, 2, 1, 3).reshape(two_l * N, halves * N)
    return d.flip(-1).reshape(d.shape[0], two_l * N).to(torch.float64) @ circ


def external_product(digits: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ExtProd(rows, digits) from the doubled table.

    ``digits`` int8 ``(B, 2L, N)``; ``table`` int32 ``(2L, 2, 2N)``
    (``prepare_trgsw``).  Returns int32 ``(B, 2, N)``.

    Exactness: |d| <= 128 and |T| <= 2^31, so |sum| <= 2L*N * 2^7 * 2^31,
    below 2^53 while 2L*N <= 2^15 (DEFAULT_PARAMS: 6144 * 2^38 ~ 2^50.6).
    """
    if digits.dtype != torch.int8:
        raise TypeError(f"digits must be int8, got {digits.dtype}")
    two_l, _, tn = table.shape
    N = tn // 2
    if two_l * N > 1 << 15:
        raise ValueError(f"2L*N = {two_l * N} breaks the float64 exactness bound")
    B = digits.shape[0]
    return wrap(circulant_product(digits, table)).reshape(B, 2, N)


def prepare_trgsw_limbs(rows: torch.Tensor) -> torch.Tensor:
    """TRGSW rows ``(..., 2L, 2, N)`` int32 -> doubled limb table
    ``(..., 2L, 2, K, 2N)`` int8: per row polynomial q and limb k,
    ``[limbs(-q)[k], limbs(q)[k]]``, the layout of ``prepare_trgsw``.

    -q is decomposed on its own: a limb of -128 has no int8 negation, so
    the limbs of -q are not the negated limbs of q (any balanced split of
    -q recombines to it).  The JAX package's table (``MatmulEngine.
    prepare_trgsw``) holds the same limbs with the halves swapped,
    ``[limbs(q), limbs(-q)]``.
    """
    neg = to_signed_limbs(-rows, LIMB_BITS, NUM_LIMBS).movedim(-1, -2)
    pos = to_signed_limbs(rows, LIMB_BITS, NUM_LIMBS).movedim(-1, -2)
    return torch.cat([neg, pos], dim=-1).contiguous()


def limb_table_from_qd(qd: torch.Tensor) -> torch.Tensor:
    """The JAX package's c-major limb table ``qd`` int8 ``(2, 2L*K, 2N)``
    (``PallasEngine.prepare_trgsw``: row j*K + k of half c holds
    ``[limbs(q)[k], limbs(-q)[k]]``) -> the port's table int8
    ``(2L, 2, K, 2N)`` (``prepare_trgsw_limbs``), whose halves are swapped,
    ``[limbs(-q)[k], limbs(q)[k]]``.

    Both tables give out[x] = sum_i d[i] * qd[(x - i) mod 2N], read as
    ``L[x - i + N]`` in the port: the map moves bytes and assumes nothing
    of them, so it also carries random bytes (the JAX probes' ``qd``)."""
    if qd.dtype != torch.int8 or qd.dim() != 3 or qd.shape[0] != 2 or qd.shape[1] % NUM_LIMBS:
        raise ValueError(f"qd must be int8 (2, 2L*{NUM_LIMBS}, 2N), got {qd.dtype} "
                         f"{tuple(qd.shape)}")
    _, rows, tn = qd.shape
    N = tn // 2
    t = qd.reshape(2, rows // NUM_LIMBS, NUM_LIMBS, tn).movedim(0, 1)  # (2L, 2, K, 2N)
    return torch.cat([t[..., N:], t[..., :N]], dim=-1).contiguous()


def external_product_limbs(digits: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ExtProd(rows, digits) from the doubled limb table, limb by limb.

    ``digits`` int8 ``(B, 2L, N)``; ``table`` int8 ``(2L, 2, K, 2N)``
    (``prepare_trgsw_limbs``).  Returns int32 ``(B, 2, N)``.

    For each limb k the sum over all 2L planes comes first, as one float64
    product against the circulant of both output halves; it is reduced mod
    2^32 as the kernels' int32 sums are, and only then recombined with a
    wrapping ``<< 8k``.  Exactness: |sum| <= 2L*N * 2^7 * 2^7, below 2^53
    while 2L*N <= 2^39.
    """
    if digits.dtype != torch.int8:
        raise TypeError(f"digits must be int8, got {digits.dtype}")
    two_l, _, num_limbs, tn = table.shape
    N = tn // 2
    B = digits.shape[0]
    out = torch.zeros((B, 2 * N), dtype=torch.int64, device=digits.device)
    for k in range(num_limbs):
        part = wrap(circulant_product(digits, table[:, :, k]))
        out += part.to(torch.int64) << (LIMB_BITS * k)
    return wrap(out).reshape(B, 2, N)


def step_digits(acc: torch.Tensor, a_tilde: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """The gadget digits of X^{a~} * acc - acc for ``acc`` int32 (B, 2, N)
    and ``a_tilde`` (B,) in [0, 2N): int32 (B, 2L, N), body digits then mask
    digits (``decomp.decompose_trlwe``)."""
    return decompose_trlwe(poly.rotate(acc, a_tilde[:, None]) - acc, params)


def cmux_step(acc: torch.Tensor, a_tilde: torch.Tensor, params: TFHEParams,
              product: Callable[[torch.Tensor], torch.Tensor],
              dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """One blind-rotate CMux step, acc + ExtProd(key, Decompose(X^{a~} * acc
    - acc)): ``acc`` plus ``product`` (the step's external product with its
    key) of ``step_digits`` cast to ``dtype``, int8 for the port's products
    (|d| <= Bg/2 <= 128), int32 for an engine that takes wider digits."""
    return acc + product(step_digits(acc, a_tilde, params).to(dtype))


def poly_mul_torus_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Negacyclic product of torus poly(s) ``a (..., N)`` int32 by the
    binary poly ``s (N,)``, exact mod 2^32 (|sum| <= N * 2^31 < 2^53)."""
    N = a.shape[-1]
    sd = torch.cat([s, -s]).to(torch.float64)
    ar = torch.arange(N, device=a.device)
    circ = sd[torch.remainder(ar[None, :] - ar[:, None], 2 * N)]  # (i, k)
    return wrap(a.to(torch.float64) @ circ)


def prepare_ksk(ksk_raw: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Raw KSK int32 ``(N, iks_l, T, n+1)`` -> float64
    ``(T-1, N*iks_l, n+1)``: slot t-1 is the row that digit value t selects
    (digits lie in [0, T), and digit 0 selects nothing)."""
    used = ksk_raw[:, :, : params.iks_t - 1, :]
    rows = params.N * params.iks_l
    return used.permute(2, 0, 1, 3).reshape(params.iks_t - 1, rows, -1).to(torch.float64)


def key_switch_digits(ksk: torch.Tensor, digits: torch.Tensor,
                      params: TFHEParams) -> torch.Tensor:
    """sum_{i,l} KSK[i, l, digits[..., i, l]] as int32 ``(..., n+1)``.

    One (digit == t) mask product per digit value t, T - 1 of them (T =
    iks_t); each selects at most N*iks_l key words of |w| <= 2^31, so
    |sum| <= (T - 1) * N*iks_l * 2^31, below 2^53 on every preset, and
    the float64 sums are exact: TEST_PARAMS 3 * 512 (2^41.6), DEFAULT and
    FAST 3 * 8192 (2^45.6), N2048 3 * 16384 (2^46.6), PBS_TEST 15 * 1024
    (2^44.9), PBS_PARAMS 15 * 8192 (2^47.9).
    """
    lead = digits.shape[:-2]
    out = key_switch_partial(ksk, digits.reshape(-1, params.N * params.iks_l), params)
    return wrap(out).reshape(lead + (ksk.shape[-1],))


def key_switch_partial(ksk: torch.Tensor, d: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """The unreduced sum of ``key_switch_digits`` over the (i, l) rows that
    ``ksk`` (T-1, R, n+1) holds: ``d`` (M, R) are the digits of those rows.
    float64 (M, n+1), an exact integer below 2^53 (the bound above holds
    for any subset of the rows), so partial sums over row shards add
    exactly before the one reduction mod 2^32 (``parallel.sharded``)."""
    out = None
    for t in range(1, params.iks_t):
        part = (d == t).to(torch.float64) @ ksk[t - 1]
        out = part if out is None else out + part
    return out
