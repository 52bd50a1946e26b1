"""The Nussbaumer transform's primitives in one kernel, on the card (P10).

Counterpart of ``benches/nussbaumer_primitives_probe.py``: the in-block
negacyclic roll by S=17 of 64-lane blocks, then the butterfly of adjacent
blocks, on a (128, 2048) tile of 32-bit words drawn from numpy seed 0 as
the JAX script draws it, checked word for word against the script's host
reference and printed as its line (``compiles: yes; exact: True``); then
the kernel's time per call by CUDA events, with the card's name and power
limit.  The call moves 2 MiB, so its time is the launch's.

Usage: python -m rustfhe_tpu_torch.benches.nussbaumer_primitives_probe
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .._u32 import from_numpy, to_numpy
from ..engine import nuss_primitives as npk
from . import _timing

TB, R = 128, 32  # the script's tile: rows, blocks per row
W = R * npk.BL
ITERS = 200


def block_neg_roll_host(x: np.ndarray, s: int) -> np.ndarray:
    """The script's host reference for the roll (uint32 numpy)."""
    x = x.reshape(x.shape[0], -1, npk.BL)
    out = np.empty_like(x)
    for t in range(npk.BL):
        src = (t - s) % npk.BL
        out[:, :, t] = x[:, :, src] if t - s >= 0 else (~x[:, :, src] + np.uint32(1))
    return out.reshape(x.shape[0], -1)


def butterfly_host(x: np.ndarray) -> np.ndarray:
    """The script's host reference for the butterfly (uint32 numpy)."""
    x = x.reshape(x.shape[0], -1, npk.BL)
    a, b = x[:, 0::2].copy(), x[:, 1::2].copy()
    out = np.empty_like(x)
    out[:, 0::2] = a + b
    out[:, 1::2] = a - b
    return out.reshape(x.shape[0], -1)


def draw() -> np.ndarray:
    """x0 (128, 2048) uint32 from numpy seed 0, as the script draws it."""
    rs = np.random.RandomState(0)
    return rs.randint(0, 2**32, size=(TB, W), dtype=np.uint64).astype(np.uint32)


def run(out=print) -> float:
    """Check, then time the kernel on the card; returns ms per call."""
    device = _timing.require_cuda()
    x0 = draw()
    x = from_numpy(x0, device)
    got = npk.nuss_primitives(x, npk.ROLL)
    torch.cuda.synchronize()
    want = butterfly_host(block_neg_roll_host(x0, npk.ROLL))
    ok = bool(np.array_equal(to_numpy(got), want))
    out(f"compiles: yes; exact: {ok}")
    if not ok:
        raise AssertionError("P10 differs from the host reference")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        npk.nuss_primitives(x, npk.ROLL)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / ITERS
    out(f"# {TB} x {W} words, S={npk.ROLL}, on {_timing.card()}: {ms * 1e3:.2f} us per call "
        f"({ITERS} calls; 2 MiB moved, {2 * TB * W * 4 / 3.35e12 * 1e6:.2f} us at 3.35 TB/s)")
    return ms


def main(argv=None) -> int:
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
