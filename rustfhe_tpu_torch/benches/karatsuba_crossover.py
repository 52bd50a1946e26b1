"""K1's two steps against each other on the card: the crossover behind
``cmux_k.KARATSUBA_MIN_ROWS``.

For DEFAULT_PARAMS and PBS_PARAMS and each batch B, a rotation of STEPS
steps (the parameters with n = STEPS) from random words, on the schoolbook
steps and on the Karatsuba steps (``cmux_k.rotate`` on either product):
first held to each other word for word, then timed in turns (schoolbook,
Karatsuba, Karatsuba, schoolbook) between CUDA events, ROUNDS rounds.  One
JSON line a batch: each step's median ms, Karatsuba over schoolbook, and
each one's share of the step's bound (``_timing.step_ops`` at 1,979
TOP/s).  Then, at the widest batch of each
set, the device time a step of each of the Karatsuba step's kernels by the
profiler.  Numbers come only from a card: without one it refuses to run.

Usage: python -m rustfhe_tpu_torch.benches.karatsuba_crossover [default|pbs[:B,B,...] ...]
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from .. import _u32
from ..engine import cmux_k, plain
from ..params import DEFAULT_PARAMS, PBS_PARAMS
from . import _timing

STEPS = 24
ROUNDS = 3
BATCHES = {
    "default": (DEFAULT_PARAMS, (256, 512, 576, 640, 768, 1024, 4096, 16384, 32768)),
    "pbs": (PBS_PARAMS, (128, 192, 256, 320, 384, 448, 512, 1024, 2048, 4096, 16384)),
}


def _case(p, B: int, device):
    rs = np.random.RandomState(B)

    def words(*shape):
        return _u32.from_numpy(rs.randint(0, 2**32, size=shape, dtype=np.uint64), device)

    acc = words(B, 2, p.N)
    a = torch.from_numpy(rs.randint(0, 2 * p.N, size=(p.n, B)).astype(np.int32)).to(device)
    key = plain.prepare_trgsw(words(p.n, 2 * p.l, 2, p.N))
    return acc, a, key, cmux_k.leaf_table(key, p)


def _ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def sweep(name: str, device, batches=None) -> None:
    base, default = BATCHES[name]
    batches = batches or default
    p = base.replace(n=STEPS)
    for B in batches:
        acc, a, key, tables = _case(p, B, device)
        school = lambda: cmux_k.rotate(acc.clone(), a, key, p, "schoolbook")  # noqa: E731
        kara = lambda: cmux_k.rotate(acc.clone(), a, tables, p, "karatsuba")  # noqa: E731
        if not torch.equal(school(), kara()):
            raise AssertionError(f"{name} B={B}: the Karatsuba rotation differs from the "
                                 "schoolbook one")
        times = {"schoolbook": [], "karatsuba": []}
        for _ in range(ROUNDS):
            for which in ("schoolbook", "karatsuba", "karatsuba", "schoolbook"):
                times[which].append(_ms(school if which == "schoolbook" else kara) / STEPS)
        least = _timing.bound(_timing.step_ops(p, B))[0]
        med = {k: statistics.median(v) for k, v in times.items()}
        print(json.dumps({
            "params": name, "B": B, "steps": STEPS, "equal": True,
            "schoolbook_ms": round(med["schoolbook"], 5), "karatsuba_ms": round(med["karatsuba"], 5),
            "ratio": round(med["karatsuba"] / med["schoolbook"], 4),
            "schoolbook_bound_pct": round(100 * least / med["schoolbook"], 2),
            "karatsuba_bound_pct": round(100 * least / med["karatsuba"], 2),
            "spread_ms": {k: [round(min(v), 5), round(max(v), 5)] for k, v in times.items()},
        }), flush=True)
        del acc, a, key, tables
    profile(name, p, batches[-1], device)


def profile(name: str, p, B: int, device) -> None:
    """The device time a step of each kernel of the Karatsuba rotation."""
    acc, a, key, tables = _case(p, B, device)
    cmux_k.rotate(acc.clone(), a, tables, p, "karatsuba")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        cmux_k.rotate(acc.clone(), a, tables, p, "karatsuba")
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and ("kernel" in e.key or "Kernel" in e.key):
            per[e.key[:60]] = round(t / 1e3 / STEPS, 5)
    print(json.dumps({"params": name, "B": B, "profile_ms_per_step": per}), flush=True)


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("karatsuba_crossover times the card: no CUDA device")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(device), "nvidia_smi": smi}),
          flush=True)
    for arg in argv or list(BATCHES):
        name, _, bs = arg.partition(":")
        sweep(name, device, tuple(int(b) for b in bs.split(",")) if bs else None)


if __name__ == "__main__":
    main(sys.argv[1:])
