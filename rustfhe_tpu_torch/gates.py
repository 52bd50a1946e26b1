"""Bootstrapped homomorphic gates, batched.

Counterpart of ``rustfhe_tpu/gates.py``.  Every gate is a linear
pre-combination of its inputs followed by one shared bootstrap:

  NAND: mu - (x + y)        AND: (x + y) - mu       OR:  (x + y) + mu
  XOR:  2(x + y) + 2mu      NOT: -x                 ANDN: -x + y - mu
"""

from __future__ import annotations

import torch

from ._u32 import s32
from .bootstrap import bootstrap
from .keys import CloudKey
from .params import TFHEParams

# Linear pre-combination coefficients (ca, cb, c_mu): pre = ca*x + cb*y +
# c_mu*mu on the body.  "andn" is and(!x, y), the mux first-pass helper.
PRE_COEFFS = {
    "nand": (-1, -1, 1),
    "and": (1, 1, -1),
    "or": (1, 1, 1),
    "xor": (2, 2, 2),
    "not": (-1, 0, 0),
    "andn": (-1, 1, -1),
}


def precombine(op: str, x: torch.Tensor, y: torch.Tensor | None = None, *,
               params: TFHEParams) -> torch.Tensor:
    """Linear gate pre-combination of TLWE batches ``(..., n+1)``."""
    ca, cb, cm = PRE_COEFFS[op]
    pre = x * ca
    if cb:
        pre = pre + y * cb
    if cm:
        pre[..., 0] += s32(cm * params.mu)
    return pre


def hom_bootstrap(ck: CloudKey, pre: torch.Tensor, *, params: TFHEParams) -> torch.Tensor:
    """Bootstrap an already pre-combined batch (the shared second half of
    every gate)."""
    return bootstrap(pre, ck, params)
