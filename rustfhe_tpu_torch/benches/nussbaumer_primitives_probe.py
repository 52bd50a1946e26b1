"""The Nussbaumer transform's primitives in one kernel, on the card (P10).

Counterpart of ``benches/nussbaumer_primitives_probe.py``: the in-block
negacyclic roll by S=17 of 64-lane blocks, then the butterfly of adjacent
blocks, on a (128, 2048) tile of 32-bit words drawn from numpy seed 0 as
the JAX script draws it, checked word for word against the script's host
reference and printed as its line (``compiles: yes; exact: True``); then
the kernel's device time per call (``torch.profiler``) beside that of
``out.copy_(x)`` on the same tensors (the least a pass over those bytes
takes in practice) and the byte bound, with the card's name and power
limit, at two shapes: the script's tile, which moves 2 MiB, so that its
time is the launch's, and the transform's size, (24576, 2048) words
(DEFAULT_PARAMS at B=4096 on the digit side: 4096 x 2L polynomials of 2N
words), 402.7 MB, where bytes set the pace.

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
TRANSFORM_ROWS = 24576  # DEFAULT_PARAMS, B=4096: 4096 x 2L polynomials of 2N = W words
SHAPES = ((TB, W), (TRANSFORM_ROWS, W))
ITERS = 200  # calls per profiler session
PROFILE_TRIES = 3  # now and then a profiler session misses launches


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


def draw(rows: int = TB) -> np.ndarray:
    """x0 (rows, 2048) uint32 from numpy seed 0; at the default 128 rows,
    as the script draws it."""
    rs = np.random.RandomState(0)
    return rs.randint(0, 2**32, size=(rows, W), dtype=np.uint64).astype(np.uint32)


def device_ms(fn, calls: int = ITERS) -> tuple[float, int]:
    """(device time per call in ms, calls of ``fn`` made) for an ``fn`` that
    launches one kernel or copy a call: the mean over the card's events
    that ``torch.profiler`` saw in ``calls`` calls, after one warm-up call.
    A session misses some launches now and then (the mean is over those it
    saw); one that saw none is run again, up to PROFILE_TRIES sessions, and
    then it raises."""
    fn()
    torch.cuda.synchronize()
    made = 1
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        made += calls
        events = [e for e in prof.key_averages() if e.device_type == cuda]
        seen = sum(e.count for e in events)
        if seen:
            return sum(e.self_device_time_total for e in events) / 1e3 / seen, made
    raise AssertionError(f"in {PROFILE_TRIES} sessions the profiler saw no launch")


def run(out=print) -> dict:
    """Check, then time the kernel and the copy on the card at SHAPES.
    Returns {"launches": calls of the kernel made, (rows, W): (kernel ms,
    copy ms, bound ms)}."""
    device = _timing.require_cuda()
    x0 = draw()
    got = npk.nuss_primitives(from_numpy(x0, device), npk.ROLL)
    torch.cuda.synchronize()
    want = butterfly_host(block_neg_roll_host(x0, npk.ROLL))
    ok = bool(np.array_equal(to_numpy(got), want))
    out(f"compiles: yes; exact: {ok}")
    if not ok:
        raise AssertionError("P10 differs from the host reference")
    result = {"launches": 1}
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    card = _timing.card()
    for rows, width in SHAPES:
        x = torch.randint(-(1 << 31), 1 << 31, (rows, width), dtype=torch.int32, device=device,
                          generator=gen)
        y = torch.empty_like(x)
        k_ms, made = device_ms(lambda: npk.nuss_primitives(x, npk.ROLL))
        c_ms, _ = device_ms(lambda: y.copy_(x))
        result["launches"] += made
        nbytes = 2 * x.numel() * 4
        b_ms = _timing.bound(nbytes=nbytes)[0]
        result[(rows, width)] = (k_ms, c_ms, b_ms)
        out(f"# ({rows}, {width}) words, S={npk.ROLL}, on {card}: device time per call "
            f"(profiler, {ITERS} calls) {k_ms * 1e3:.2f} us, out.copy_(x) {c_ms * 1e3:.2f} us; "
            f"{nbytes / 1e6:.1f} MB moved, bound {b_ms * 1e3:.2f} us at 3.35 TB/s: the kernel "
            f"at {b_ms / k_ms:.1%} of it, the copy at {b_ms / c_ms:.1%}")
        del x, y
    return result


def main(argv=None) -> int:
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
