"""Where the Karatsuba step's time goes, by ablation, on the card (P4).

Counterpart of ``benches/k2_floor_probe.py``: the production two-level
Karatsuba step (K1's function in the residue layout) and seven forms that
each drop one part, through ``karatsuba_probe.step_ablate``, timed by
``_timing.chain``, then the attribution full - variant per part:

  full       the production step
  norot      the rotation skipped (diff = a~ as a word)
  noextract  every level gets the top digit
  notree     every tree plane is residue 0
  nodots     no products (the TPU probe's broadcast add)
  norecomb   limb 0 only
  nocombine  output residue i is leaf i
  accio      the accumulator's round trip alone (acc + 1)

The JAX probe encrypts 1 under a jax.random key for its TRGSW rows; the
port cannot reproduce jax's bits, so the rows, a~ and the accumulator are
random words from numpy seed 0 (the values do not change the time).
``PRESET=pbs`` runs the same ablations at PBS_PARAMS (N=2048, l=4), as the
JAX probe does.

Usage: python -m rustfhe_tpu_torch.benches.k2_floor_probe [B] [which ...]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import _u32
from ..engine import karatsuba, karatsuba_probe
from ..params import DEFAULT_PARAMS as P
from ..params import PBS_PARAMS
from . import _timing
from ._timing import Case

DEFAULT_B = 8192
ORDER = tuple(karatsuba_probe.ABLATIONS)


def macs(p) -> int:
    """The reference's int8 MACs per sample and step at ``p``."""
    return 2 * p.l * p.N * 2 * 4 * p.N


MACS_FULL = macs(P)
TB_NOTE = ("# the TPU's batch tile tb=128 has no counterpart: a block tile of the leaf "
           "product holds 128 samples and 64 coefficients of one output half of a leaf")


def preset():
    """PBS_PARAMS under ``PRESET=pbs`` (the JAX probe's switch), else DEFAULT_PARAMS."""
    return PBS_PARAMS if os.environ.get("PRESET") == "pbs" else P


def draw_acc(rs: np.random.RandomState, B: int, device, p=P):
    """acc (B, 2, N) and a~ (B,) from ``rs``, in this order (the JAX
    scripts' numpy order)."""
    acc = _u32.from_numpy(rs.randint(0, 2**32, size=(B, 2, p.N), dtype=np.uint64), device)
    a_t = torch.from_numpy(rs.randint(0, 2 * p.N, size=(B,)).astype(np.int32)).to(device)
    return acc, a_t


def draw_step(rs: np.random.RandomState, B: int, device, p=P):
    """Random rows, then acc and a~ (``draw_acc``) from ``rs`` -> (residue-
    layout acc, a~, the leaf table, the K1 key, the standard acc)."""
    from ..engine import plain

    rows = _u32.from_numpy(rs.randint(0, 2**32, size=(2 * p.l, 2, p.N), dtype=np.uint64),
                           device)
    acc, a_t = draw_acc(rs, B, device, p)
    return (karatsuba.scan_enter(acc), a_t, karatsuba.prepare_table(rows),
            plain.prepare_trgsw(rows), acc)


def parse(argv) -> tuple[int, tuple[str, ...]]:
    B = int(argv[0]) if argv else DEFAULT_B
    which = set(argv[1:]) or set(ORDER)
    unknown = sorted(which - set(ORDER))
    if unknown:
        raise SystemExit(f"unknown variant(s) {', '.join(unknown)}; known: {', '.join(ORDER)}")
    return B, tuple(n for n in ORDER if n in which)


def cases(B: int, which, device, p=P) -> list:
    acc0, a_t, tab, _, _ = draw_step(np.random.RandomState(0), B, device, p)
    ops = 2 * B * macs(p)
    return [Case(name, lambda a, name=name: karatsuba_probe.step_ablate(a, a_t, tab, p, name),
                 acc0, ops) for name in which]


def run(B: int = DEFAULT_B, which=ORDER, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print, p=P) -> dict[str, float]:
    """Time ``which`` at batch B and parameters ``p`` on the card and print
    the attribution; {line name: seconds per step}."""
    device = _timing.require_cuda()
    _timing.header(f"Karatsuba step ablations (P4), N={p.N} l={p.l} n={p.n}", B, out)
    out(TB_NOTE)
    out("# inputs: random rows, a~ and acc from numpy seed 0 (the JAX probe's jax.random "
        "TRGSW of 1 is not reproduced; the values do not change the time)")
    times = _timing.run_cases(cases(B, which, device, p), steps, reps, out)
    if "full" in times:
        out("\n# component attribution (full - variant):")
        for name in ORDER[1:]:
            if name in times:
                out(f"#   {name:10s}: {1e3 * (times['full'] - times[name]):+.3f} ms")
    return times


def main(argv=None) -> int:
    B, which = parse(sys.argv[1:] if argv is None else argv)
    run(B, which, p=preset())
    return 0


if __name__ == "__main__":
    sys.exit(main())
