"""The Nussbaumer transform's primitives in one kernel (P10).

Counterpart of the Pallas probe kernel of ``benches/nussbaumer_primitives_probe.py``
(``main``, :57; body ``kernel``, :43): on a (rows, W) tile of 32-bit words,
seen as blocks of ``BL`` = 64 lanes, every block is rolled negacyclically by
S (lane t takes lane t - S of its block, the lanes t < S the wrapped word
negated), then adjacent blocks (2i, 2i+1) = (a, b) become (a + b, a - b),
wrapping mod 2^32.  These are the in-block twiddle and the radix-2 stage
of the transform-domain engine (``engine/transform.py``).

The kernel is CUDA C++ for sm_90a in ``csrc/nuss_primitives.cu``, built
with nvcc on first use and called through ctypes (``launch``): a warp owns
whole block pairs (16-byte loads and stores, the roll and the butterfly by
warp shuffles), so it moves each word once, as its byte bound counts.
``nuss_primitives`` dispatches on the device of its tensor: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
``nuss_primitives.launches`` counts the kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import launch
from .launch import INT, VP, check_tensor, dispatch

BL = 64  # lanes per block
ROLL = 17  # the probe's roll


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the library of ``csrc/nuss_primitives.cu``.
    Raises RuntimeError when no CUDA device is available."""
    return launch.bind("nuss_primitives", {"rustfhe_nuss_primitives": [VP, VP, INT, INT, INT, VP]})


def _check_args(x: torch.Tensor, s: int) -> None:
    if x.dim() != 2 or x.shape[1] % (2 * BL) or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (rows, W) with W a multiple of {2 * BL}, got "
                         f"{tuple(x.shape)}")
    check_tensor("x", x, torch.int32, tuple(x.shape), x.device)
    if not 0 <= s < BL:
        raise ValueError(f"the roll S must lie in [0, {BL}), got {s}")


def nuss_primitives_plain(x: torch.Tensor, s: int = ROLL) -> torch.Tensor:
    """The plain version: int32 words (rows, W) -> (rows, W), the block
    roll by ``s`` then the butterfly of adjacent blocks."""
    _check_args(x, s)
    rows, width = x.shape
    blk = x.reshape(rows, width // BL, BL)
    rolled = torch.cat([-blk[..., BL - s:], blk[..., : BL - s]], dim=-1)
    a, b = rolled[:, 0::2], rolled[:, 1::2]
    return torch.stack([a + b, a - b], dim=2).reshape(rows, width)


def nuss_primitives(x: torch.Tensor, s: int = ROLL) -> torch.Tensor:
    """Block roll by ``s`` then block butterfly of int32 words ``x`` (rows,
    W), W a multiple of 128; on the card one launch of the kernel."""
    _check_args(x, s)
    if not dispatch(x.device):
        return nuss_primitives_plain(x, s)
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel loads 16 bytes a lane)")
    out = torch.empty_like(x)
    launch.call(load_library(), "rustfhe_nuss_primitives", x, out, x.shape[0], x.shape[1], s)
    nuss_primitives.launches += 1
    return out


def reset_counters() -> None:
    nuss_primitives.launches = 0


reset_counters()
