"""Torus32 codec on int32 tensors.

Counterpart of ``rustfhe_tpu/torus.py``.  A torus word is the int32 with
the bits of the uint32 fixed-point fraction (see ``_u32``); encodings are
bit-exact with the JAX package:

  * float -> torus: ``(frac(x) * 2^32)`` truncated toward zero.
  * Binary message: One -> +1/8 = 0x2000_0000, Zero -> -1/8 = 0xE000_0000.
  * Decode: fraction < 0.5 -> One, i.e. the int32 word is >= 0.
"""

from __future__ import annotations

import torch

from ._u32 import as_u32_int64, s32, ult, wrap

TORUS_ONE_EIGHTH = s32(0x20000000)  # +1/8
TORUS_MINUS_ONE_EIGHTH = s32(0xE0000000)  # -1/8


def from_double(x: torch.Tensor) -> torch.Tensor:
    """Encode floats in R to Torus32: frac(x) scaled by 2^32, truncated.

    Computed in the input's float type (float32 for integer input), as the
    JAX package does.  The scaled value can reach 2^32 - 2^8 >= 2^31, which
    a direct float -> int32 cast would saturate, so it goes through int64
    and wraps."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    # The second fract matters for tiny negative x, where x - floor(x)
    # rounds to exactly 1.0.
    frac = x - torch.floor(x)
    frac = frac - torch.floor(frac)
    frac = torch.where(frac >= 1.0, torch.zeros_like(frac), frac)
    scaled = frac * 4294967296.0
    return wrap(scaled.to(torch.float64).to(torch.int64))


def to_double(t: torch.Tensor) -> torch.Tensor:
    """Decode Torus32 words to float64 fractions in [0, 1)."""
    return as_u32_int64(t).to(torch.float64) / 4294967296.0


def binary_to_torus(b: torch.Tensor) -> torch.Tensor:
    """Binary {0,1} -> Torus32 message +-1/8."""
    b = torch.as_tensor(b)
    one = torch.full(b.shape, TORUS_ONE_EIGHTH, dtype=torch.int32, device=b.device)
    return torch.where(b != 0, one, torch.full_like(one, TORUS_MINUS_ONE_EIGHTH))


def torus_to_binary(t: torch.Tensor) -> torch.Tensor:
    """Torus32 -> Binary {0,1}: fraction < 0.5 (word < 0x8000_0000) is One."""
    return (t >= 0).to(torch.int32)


def signed_to_torus(v, shift: int) -> torch.Tensor:
    """Exact encoding v * 2^(32 - shift) mod 2^32 of small integers ``v``
    (an int or an integer tensor): zeros unless 0 < shift < 32, as the JAX
    package's uint32 shift gives."""
    v = torch.as_tensor(v).to(torch.int64) & 0xFFFFFFFF
    if not 0 < shift < 32:
        return torch.zeros_like(v, dtype=torch.int32)
    return wrap(v << (32 - shift))


def pow_two_minus(k: int) -> int:
    """Torus value 2^-k, as the int32 word with its bits (0 for k = 0)."""
    if k == 0:
        return 0
    k = min(k, 32)
    return s32(1 << (32 - k))


def is_in(a: torch.Tensor, b, radius_pow: int = 10) -> torch.Tensor:
    """True where the circular distance |a - b| (mod 1) is below
    2^-radius_pow: the wrapping form of the JAX package's ``is_in``."""
    d = a - b
    nd = -d
    dist = torch.where(ult(d, nd), d, nd)  # min(d, 2^32 - d), unsigned
    return ult(dist, pow_two_minus(radius_pow))
