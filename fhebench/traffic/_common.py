"""What the generators share: the block schedule and the ciphertexts of
bits and integers."""

from __future__ import annotations

import numpy as np
import torch

from fhebench.reference import tfhe as ref


class Schedule:
    """Request i is (kind, pool index).  Requests come in blocks of
    ``len(kinds)``: each block is a seed-drawn permutation of every kind
    once, so every seed sends the same mix of work in another order."""

    def __init__(self, rng: np.random.Generator, kinds, pool: int):
        self.rng = np.random.default_rng(rng.integers(1 << 62))
        self.kinds, self.pool = list(kinds), pool
        self.order: list[int] = []
        self.index: list[int] = []

    def __call__(self, i: int):
        while len(self.order) <= i:
            self.order.extend(self.rng.permutation(len(self.kinds)).tolist())
            self.index.extend(self.rng.integers(0, self.pool, len(self.kinds)).tolist())
        return self.kinds[self.order[i]], self.index[i]


def encrypt_bits(run, b: torch.Tensor) -> torch.Tensor:
    """Gate-encoded TLWE of {0, 1} values under the benchmark's key."""
    return ref.encrypt(run.gen, run.keys.s0, ref.bit_words(b), run.rp.alpha_lv0)


def split(values: torch.Tensor, digits: int, bits: int) -> torch.Tensor:
    """Unsigned values (...) -> their ``digits`` base-2^bits digits, least
    significant first: (..., digits)."""
    shifts = torch.arange(digits, device=values.device) * bits
    return (values[..., None] >> shifts) & ((1 << bits) - 1)


def join(digits: np.ndarray, bits: int) -> np.ndarray:
    """(..., digits) -> the unsigned values."""
    w = np.arange(digits.shape[-1], dtype=np.int64) * bits
    return (digits.astype(np.int64) << w).sum(axis=-1)
