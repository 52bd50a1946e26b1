"""The float64-FFT engine ``"fft64"``.

Counterpart of ``rustfhe_tpu/engine/fft64.py`` (``FFT64Engine``), the
reference's own spqlios trick: the negacyclic product as a length-2N real
FFT convolution in float64, rounded back to exact integers.

* Key words are split into two balanced signed 16-bit limbs, so every
  per-limb convolution coefficient is at most 2L * N * half_bg * 2^15 in
  magnitude (2^32.6 at DEFAULT_PARAMS).
* The FFT's rounding error is about 2^-52 * log2(2N) * |coefficient|;
  ``check_bound`` raises unless that stays below 1/4, so ``round``
  recovers every integer (JAX's engine states the bound; here it is
  checked, not assumed).
* The negacyclic product of length N is the first N coefficients of the
  circular convolution of length 2N of ``[a, -a]`` with ``[b, 0]``: the
  doubling lives on the prepared key.

``torch.fft`` computes the transforms (cuFFT on the card), as XLA's FFT
does for the JAX engine.  The key switch is the matmul engine's.
"""

from __future__ import annotations

import math
from typing import ClassVar

import torch

from .._u32 import wrap
from ..params import TFHEParams
from ..poly import to_signed_limbs
from .matmul import MatmulEngine, recombine

CONV_LIMB_BITS = 16
CONV_NUM_LIMBS = 2


def check_bound(params: TFHEParams) -> None:
    """Raise unless the float64 FFT convolution is exact: per-limb sums of
    2L*N products of digits (|d| <= half_bg) and 16-bit limbs must round
    back from an error below 1/4."""
    coef = 2 * params.l * params.N * params.half_bg * 2 ** (CONV_LIMB_BITS - 1)
    err = coef * 2.0 ** -52 * math.log2(2 * params.N)
    if err >= 0.25:
        raise ValueError(f"fft64: convolution sums up to {coef:.3g} give a float64 FFT error "
                         f"of ~{err:.3g}, not below 1/4: inexact at N={params.N}, "
                         f"l={params.l}, bgbit={params.bgbit}")


class FFT64Engine:
    """Exact float64-FFT negacyclic convolution engine."""

    name: ClassVar[str] = "fft64"

    def __init__(self):
        self._ks = MatmulEngine()

    def _prepare_poly(self, x: torch.Tensor) -> torch.Tensor:
        """int32 words (..., N) -> rfft of ``[limbs, -limbs]``: complex128
        (..., K, N+1)."""
        limbs = to_signed_limbs(x, CONV_LIMB_BITS, CONV_NUM_LIMBS, dtype=torch.int32)
        limbs = limbs.movedim(-1, -2).to(torch.float64)
        return torch.fft.rfft(torch.cat([limbs, -limbs], dim=-1), dim=-1)

    def prepare_trgsw(self, rows: torch.Tensor, params: TFHEParams) -> torch.Tensor:
        """TRGSW rows int32 ``(..., 2L, 2, N)`` -> complex128
        ``(..., 2L, 2, K, N+1)``."""
        check_bound(params)
        return self._prepare_poly(rows)

    def external_product_digits(self, prepared: torch.Tensor, digits: torch.Tensor,
                                params: TFHEParams) -> torch.Tensor:
        """``prepared`` complex128 ``(2L, 2, K, N+1)``; ``digits`` integers
        ``(..., 2L, N)`` -> int32 ``(..., 2, N)``."""
        check_bound(params)
        return self.round_recombine(self.conv_partial(prepared, digits, params))

    def conv_partial(self, prepared: torch.Tensor, digits: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
        """The per-limb float64 convolution sums before rounding: ``prepared``
        complex128 ``(R, 2, K, N+1)``, ``digits`` ``(..., R, N)`` for any R
        rows (2L, or a tensor-parallel shard of them) -> float64 ``(..., 2,
        K, N)``.  Each is an integer up to the FFT's error, so partials over
        row shards may be summed before ``round_recombine`` (the JAX
        engine's ``_conv_partial``)."""
        N = params.N
        df = torch.fft.rfft(digits.to(torch.float64), n=2 * N, dim=-1)  # (..., R, N+1)
        prod = torch.einsum("...jf,jckf->...ckf", df, prepared)
        return torch.fft.irfft(prod, n=2 * N, dim=-1)[..., :N]

    def round_recombine(self, part: torch.Tensor) -> torch.Tensor:
        """float64 limb sums ``(..., 2, K, N)`` -> int32 words ``(..., 2, N)``."""
        return recombine(wrap(part.round()), CONV_LIMB_BITS)

    def prepare_ksk(self, ksk_raw: torch.Tensor, params: TFHEParams) -> torch.Tensor:
        return self._ks.prepare_ksk(ksk_raw, params)

    def key_switch_digits(self, prepared: torch.Tensor, digits: torch.Tensor,
                          params: TFHEParams) -> torch.Tensor:
        return self._ks.key_switch_digits(prepared, digits, params)

    def poly_mul_torus_binary(self, a: torch.Tensor, s: torch.Tensor,
                              params: TFHEParams | None = None) -> torch.Tensor:
        """``a`` int32 ``(..., N)``; ``s`` {0,1} ``(N,)`` -> int32 ``(..., N)``
        (|sum| <= N * 2^15)."""
        N = a.shape[-1]
        sf = torch.fft.rfft(s.to(torch.float64), n=2 * N, dim=-1)
        full = torch.fft.irfft(self._prepare_poly(a) * sf, n=2 * N, dim=-1)[..., :N]
        return recombine(wrap(full.round()), CONV_LIMB_BITS)
