"""The probes' chain timer and header line.

The JAX probes ran STEPS applications inside one jit so that a dispatch
did not dominate (``benches/step_breakdown_probe.py:56-77``).  Here STEPS
launches run back to back on one stream, each on the previous one's
output (a data-dependent chain, as the JAX probes build it), between two
CUDA events; REPS chains are timed together, and the time per step is
their mean.  Numbers come only from a card: without a CUDA device the
probes refuse to run.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Callable

import torch

STEPS = 16
REPS = 3


@dataclass
class Case:
    """One timed line: ``step`` maps x to the next x, ``steps_per_call``
    steps at a time; ``ops`` counts the operations of one step (2 per
    multiply-add)."""

    name: str
    step: Callable
    x0: torch.Tensor
    ops: float
    unit: str = "TOPS-equiv"
    steps_per_call: int = 1


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
    out(f"{case.name:40s} {dt * 1e3:9.3f} ms/step  {case.ops / dt / 1e12:7.1f} {case.unit}")
    return dt


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
