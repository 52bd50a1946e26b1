"""Naive exact external product: the ground truth.

Counterpart of ``rustfhe_tpu/engine/oracle.py``.  The kernels and the plain
versions are held to this function word for word (integer mod 2^32, no
tolerance).  It works on raw TRGSW rows, not on any prepared form.
``OracleEngine`` is the same product behind the generic-engine methods,
registered as ``"oracle"`` as in the JAX package.
"""

from __future__ import annotations

from typing import ClassVar

import torch

from .._u32 import wrap
from ..poly import negacyclic_mul_torus_oracle


def external_product(rows: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """out[..., c, :] = sum_j digits[..., j, :] (*) rows[j, c, :] mod 2^32.

    ``rows`` int32 words ``(2L, 2, N)``; ``digits`` integers ``(..., 2L, N)``.
    Returns int32 ``(..., 2, N)``.
    """
    out = None
    for j in range(rows.shape[0]):
        prod = negacyclic_mul_torus_oracle(rows[j], digits[..., j, None, :])
        out = prod if out is None else out + prod
    return out


class OracleEngine:
    """The naive engine ``"oracle"``: O(N^2) per product, exact."""

    name: ClassVar[str] = "oracle"

    def prepare_trgsw(self, rows: torch.Tensor, params) -> torch.Tensor:
        return rows  # no precomputation: the raw rows (..., 2L, 2, N)

    def external_product_digits(self, prepared: torch.Tensor, digits: torch.Tensor,
                                params) -> torch.Tensor:
        return external_product(prepared, digits)

    def poly_mul_torus_binary(self, a: torch.Tensor, s: torch.Tensor, params) -> torch.Tensor:
        return negacyclic_mul_torus_oracle(a, s)

    def prepare_ksk(self, ksk_raw: torch.Tensor, params) -> torch.Tensor:
        """(N, iks_l, T, n+1) raw -> (N, iks_l, T+1, n+1) with a zero slot
        first, so that digit d indexes its slot directly."""
        zeros = torch.zeros(ksk_raw.shape[:2] + (1,) + ksk_raw.shape[3:], dtype=torch.int32,
                            device=ksk_raw.device)
        return torch.cat([zeros, ksk_raw], dim=2)

    def key_switch_digits(self, prepared: torch.Tensor, digits: torch.Tensor,
                          params) -> torch.Tensor:
        """sum over (i, l) of prepared[i, l, digits[..., i, l]], mod 2^32;
        ``digits`` (..., N, iks_l) in [0, T]."""
        i = torch.arange(params.N, device=prepared.device)[:, None]
        lv = torch.arange(params.iks_l, device=prepared.device)[None, :]
        sel = prepared[i, lv, digits.long()]  # (..., N, iks_l, n+1)
        return wrap(sel.to(torch.int64).sum(dim=(-3, -2)))
