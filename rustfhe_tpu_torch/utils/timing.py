"""Timing and profiling helpers.

Counterpart of ``rustfhe_tpu/utils/timing.py``.  CUDA work is
asynchronous, so each timer synchronises the CUDA device it is given (or
the current one, once CUDA is in use) before it starts the clock and
before it stops it; the CPU needs nothing.  ``profile_trace``
records a ``torch.profiler`` trace (CPU, and the card's kernels where
CUDA is available) and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _synchronize(device=None) -> None:
    """Wait for the CUDA device ``device`` names (a device, or a tensor on
    it), else for the current one once CUDA is in use; nothing for the
    CPU."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timeit(label: str, result_holder: dict | None = None, sync=None):
    """Print ``label: <micros> us`` around a block, the device synchronised
    at both ends (``sync``: a tensor or a device, else the current CUDA
    device)."""
    _synchronize(sync)
    t0 = time.perf_counter()
    yield
    _synchronize(sync)
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder[label] = dt
    print(f"{label}: {dt * 1e6:.0f} us")


def time_fn(fn, *args, iters: int = 3, warmup: int = 1, device=None):
    """Best-of-``iters`` seconds of ``fn(*args)`` after ``warmup`` calls,
    each call timed between synchronisations of ``device`` (else the
    current CUDA device).  Returns (best seconds, last output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    best = float("inf")
    for _ in range(iters):
        _synchronize(device)
        t0 = time.perf_counter()
        out = fn(*args)
        _synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the block with ``torch.profiler`` and write the trace to
    ``logdir/trace.json`` (chrome://tracing, Perfetto).  Yields the
    profiler, whose ``key_averages()`` the caller may read after the
    block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
