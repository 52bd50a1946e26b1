"""Naive exact external product: the ground truth.

Counterpart of ``rustfhe_tpu/engine/oracle.py``.  The kernels and the plain
versions are held to this function word for word (integer mod 2^32, no
tolerance).  It works on raw TRGSW rows, not on any prepared form.
"""

from __future__ import annotations

import torch

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
