"""uint32 torus words carried in ``torch.int32`` tensors.

No JAX counterpart: the JAX package computes on ``jnp.uint32`` directly.
``torch.uint32`` has no add, shift or compare in torch 2.13, so the port
keeps every torus word as the int32 with the same 32 bits.  Add, subtract,
multiply, negate, the bitwise operations and left shift give the same bits
on int32 as on uint32 (wrapping mod 2^32); the operations whose meaning
depends on the sign live here: logical right shift, unsigned compare, the
reduction of wide sums mod 2^32, and the exchange with numpy ``uint32``.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MIN = -(1 << 31)


def s32(v: int) -> int:
    """A uint32 constant (any Python int, taken mod 2^32) -> the int32
    Python int with the same 32 bits, ready to combine with int32 tensors."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def from_numpy(a, device=None) -> torch.Tensor:
    """numpy uint32 array (or anything numpy reads as one) -> int32 tensor
    with the same bits, copied onto ``device``."""
    a = np.asarray(a).astype(np.uint32, order="C")  # a fresh copy, 0-d kept
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 array with the same bits (host copy)."""
    if t.dtype != torch.int32:
        raise TypeError(f"torus words are int32 tensors, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of 32-bit words by a static ``k`` in [0, 32).

    ``>>`` on int32 is arithmetic; masking off the ``k`` sign-filled top
    bits gives the uint32 shift."""
    if not 0 <= k < 32:
        raise ValueError(f"shift must be in [0, 32), got {k}")
    if k == 0:
        return x
    return (x >> k) & ((1 << (32 - k)) - 1)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a < b`` on 32-bit words: flipping the top bit maps the
    uint32 order onto the int32 order.  ``b`` is a tensor or a uint32 int."""
    if isinstance(b, int):
        return (a ^ INT32_MIN) < (s32(b) ^ INT32_MIN)
    return (a ^ INT32_MIN) < (b ^ INT32_MIN)


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Integer-valued tensor (int64 sums, or float64 sums exact below
    2^53) -> int32 holding the value mod 2^32."""
    x = x.to(torch.int64)
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def as_u32_int64(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 values in [0, 2^32) (the unsigned reading)."""
    return x.to(torch.int64) & 0xFFFFFFFF
