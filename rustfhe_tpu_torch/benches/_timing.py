"""The probes' chain timer, host timer and header line.

The JAX probes ran STEPS applications inside one jit so that a dispatch
did not dominate (``benches/step_breakdown_probe.py:56-77``).  Here STEPS
launches run back to back on one stream, each on the previous one's
output (a data-dependent chain, as the JAX probes build it), between two
CUDA events; REPS chains are timed together, and the time per step is
their mean.  Numbers come only from a card: without a CUDA device the
probes refuse to run.  ``host_seconds`` times work that reads back to the
host or spans many launches (a whole rotation, a console expression) on
the host clock, the card synchronised before and after.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..engine import cmux_k, rotate_all_k

STEPS = 16
REPS = 3
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak of an H100 SXM at 700 W (published)
HBM_BYTES_PER_S = 3.35e12  # device-memory rate of an H100 SXM (published)


@dataclass
class Case:
    """One timed line: ``step`` maps x to the next x, ``steps_per_call``
    steps at a time; ``ops`` counts the operations of one step (2 per
    multiply-add).  ``bound_s``, when given, is the least time the card
    could take for one step; the line then prints its share."""

    name: str
    step: Callable
    x0: torch.Tensor
    ops: float
    unit: str = "TOPS-equiv"
    steps_per_call: int = 1
    bound_s: float | None = None


def bound(ops: float = 0.0, nbytes: float = 0.0) -> tuple[float, str]:
    """The least time on the card (ms) for ``ops`` int8 operations and
    ``nbytes`` of device memory (each input read once, each output written
    once), against the published peaks, and which of the two bounds it."""
    t_ops, t_bytes = ops / INT8_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def step_ops(p, b: int, steps: int = 1) -> float:
    """The operations of ``steps`` CMux steps (or external products) of b
    samples, whatever computes them: the least int8 count the repo shows
    for the step, the two-level Karatsuba product's 2 x (2 halves x 4 limbs
    x 2L x 9 leaves x (N/4)^2) per sample and step, 0.5625 of
    ``schoolbook_ops``.  Every CMux step's and external product's bound
    counts these."""
    return 2.0 * b * steps * 2 * 4 * 2 * p.l * 9 * (p.N // 4) ** 2


def schoolbook_ops(p, b: int, steps: int = 1) -> float:
    """The int8 multiply-adds (x2) of the schoolbook product, 2 x (2 halves
    x 4 limbs x 2L x N^2) per sample and step: what K1's GEMM executes,
    used for its own rate, never for a bound."""
    return 2.0 * b * steps * 2 * 4 * 2 * p.l * p.N * p.N


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("the probes time the CUDA kernels and need a CUDA device "
                         "(torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
                             capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name()}, power limit not measured"
    return out.strip().splitlines()[0]


def header(what: str, B: int, out=print) -> None:
    out(f"# {what} on {card()}  B={B}  steps/chain={STEPS} x {REPS}")


def chain(case: Case, steps: int = STEPS, reps: int = REPS, out=print) -> float:
    """Seconds per step of ``case`` (after one warm-up call), printed with
    its rate."""
    torch.cuda.synchronize()
    case.step(case.x0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    x = case.x0
    start.record()
    for _ in range(steps * reps):
        x = case.step(x)
    end.record()
    end.synchronize()
    dt = start.elapsed_time(end) / 1e3 / (steps * reps * case.steps_per_call)
    share = "" if case.bound_s is None else f"  {case.bound_s / dt:6.1%} of bound"
    out(f"{case.name:40s} {dt * 1e3:9.3f} ms/step  {case.ops / dt / 1e12:7.1f} {case.unit}{share}")
    return dt


def host_seconds(fn: Callable, iters: int = 1) -> float:
    """Mean seconds of ``fn()`` over ``iters`` calls in a row on the host
    clock, the card synchronised before the first and after the last."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def run_cases(cases, steps: int = STEPS, reps: int = REPS, out=print) -> dict[str, float]:
    """Time every Case of ``cases`` in order and print each str as a note.
    Returns {name: seconds per step}."""
    times = {}
    for c in cases:
        if isinstance(c, str):
            out(c)
        else:
            times[c.name] = chain(c, steps, reps, out)
    return times


def rotation_launches() -> dict[str, int]:
    """The rotation kernels' launch counts: K1's steps, K1's steps on a
    prebuilt panel (a hybrid key's) and K3's whole rotations."""
    return {"K1": cmux_k.cmux_step.launches, "K1 panel": cmux_k.cmux_step_panel.launches,
            "K3": rotate_all_k.rotate_all.launches}


def ran(before: dict[str, int]) -> str:
    """Which rotation kernels launched since ``before`` (``rotation_launches``)."""
    now = rotation_launches()
    got = {k: now[k] - before[k] for k in now if now[k] != before[k]}
    return ", ".join(f"{k} x{v}" for k, v in got.items()) or "no rotation kernel"
