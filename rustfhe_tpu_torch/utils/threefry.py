"""Threefry-2x32, bit for bit as ``jax.random`` draws it.

No module of the JAX package is behind this one: its counterpart is
``jax.random`` (``jax/_src/prng.py``) under the configuration the JAX
package runs with, ``jax_threefry_partitionable = True`` (the default
since JAX 0.5).  The JAX package draws a seeded ciphertext's mask with
``jax.random.bits(seed, shape, uint32)``, so a server that expands one
(``tlwe.expand_seeded``) must re-derive the same words.  Only the
partitionable form is here:

  * ``threefry2x32``: the 20-round Threefry-2x32 hash (rotations 13, 15,
    26, 6 and 17, 29, 16, 24; key parity word 0x1BD11BDA; a key injection
    every 4 rounds);
  * ``split(key, num)``: row i is the hash of the 64-bit counter i, as
    (high word, low word) (``_threefry_split_foldlike``);
  * ``fold_in(key, data)``: the hash of the counter (0, data);
  * ``random_bits(key, shape)``: word i of the flattened shape is
    ``y0 ^ y1`` of the hash of counter i (``_threefry_random_bits_partitionable``),
    so a word depends on its flat index only, not on the shape.

The JAX package computes this in XLA, not in Pallas, so plain torch is its
counterpart: integer ops on the port's int32 word carriers (``_u32.py``),
on the device of the tensors given (the card for a CUDA tensor).  A key is
a (2,) int32 tensor of words (``key_words`` takes numpy words too).  One
draw is at most 2^31 words (JAX allows 2^64).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._u32 import from_numpy, s32

PRNG = "threefry2x32-partitionable"  # the name the seeded npz records
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
MAX_WORDS = 1 << 31  # one draw's words


def key_words(key, device=None) -> torch.Tensor:
    """A threefry key -> its (2,) int32 words on ``device`` (the key's own
    for a tensor, else the CPU).  A tensor must hold int32 words; numpy
    arrays and sequences must be integers in [-2^31, 2^32), read mod 2^32."""
    if isinstance(key, torch.Tensor):
        if key.dtype != torch.int32:
            raise TypeError(f"a threefry key is int32 words, got {key.dtype}")
        words = key
    else:
        a = np.asarray(key)
        if a.dtype.kind not in "iu":
            raise TypeError(f"a threefry key is 32-bit integer words, got {a.dtype}")
        if a.size and (int(a.min()) < -(1 << 31) or int(a.max()) >= 1 << 32):
            raise ValueError("a threefry key's words must fit 32 bits")
        words = from_numpy(a.astype(np.int64).astype(np.uint32))
    if tuple(words.shape) != (2,):
        raise ValueError(f"a threefry key is (2,) words, got shape {tuple(words.shape)}")
    return words.to(device if device is not None else words.device)


def _rotl_(x: torch.Tensor, r: int, tmp: torch.Tensor) -> None:
    """x <- x rotated left by r, in place (``tmp`` is scratch of x's shape)."""
    torch.bitwise_left_shift(x, r, out=tmp)
    x.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)  # the logical shift (_u32.srl)
    x.bitwise_or_(tmp)


def _hash_(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor) -> None:
    """Threefry-2x32 of the counters (x0, x1) under the key (k0, k1), in
    place on two int32 tensors of one shape (JAX's
    ``_threefry2x32_lowering``)."""
    ks = (s32(k0), s32(k1), s32(k0 ^ k1 ^ PARITY))
    tmp = torch.empty_like(x1)
    x0.add_(ks[0])
    x1.add_(ks[1])
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0.add_(x1)
            _rotl_(x1, r, tmp)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(s32(ks[(i + 2) % 3] + i + 1))


def _key_ints(key) -> tuple[int, int]:
    k0, k1 = key_words(key).tolist()
    return k0, k1


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The hash of the counters (x0, x1), int32 words of one shape, under
    ``key``: two new tensors (``jax._src.prng.threefry2x32_p``)."""
    if x0.dtype != torch.int32 or x1.dtype != torch.int32 or x0.shape != x1.shape:
        raise ValueError("the counters are two int32 tensors of one shape")
    y0, y1 = x0.clone(), x1.clone()
    _hash_(*_key_ints(key), y0, y1)
    return y0, y1


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) int32 key words."""
    k = key_words(key)
    y1 = torch.arange(num, dtype=torch.int32, device=k.device)
    y0 = torch.zeros_like(y1)
    _hash_(*_key_ints(k), y0, y1)
    return torch.stack([y0, y1], dim=1)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for ``data`` in [0, 2^32): (2,)
    int32 key words."""
    if not 0 <= int(data) < 1 << 32:
        raise ValueError(f"fold_in data must lie in [0, 2^32), got {data}")
    k = key_words(key)
    y0 = torch.zeros(1, dtype=torch.int32, device=k.device)
    y1 = torch.full((1,), s32(int(data)), dtype=torch.int32, device=k.device)
    _hash_(*_key_ints(k), y0, y1)
    return torch.cat([y0, y1])


def random_bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: int32 words of ``shape`` on
    ``device`` (the key's by default)."""
    k = key_words(key)
    device = k.device if device is None else torch.device(device)
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    if n > MAX_WORDS:
        raise ValueError(f"one draw is at most 2^31 words, asked for {n}")
    k0, k1 = _key_ints(k)
    x1 = torch.arange(n, dtype=torch.int32, device=device)  # the counter's low word
    x0 = torch.zeros_like(x1)  # its high word
    _hash_(k0, k1, x0, x1)
    return x0.bitwise_xor_(x1).reshape(shape)
