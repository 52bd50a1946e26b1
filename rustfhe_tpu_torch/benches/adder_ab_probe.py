"""The integer adder cells on the card: Kogge-Stone against ripple.

Counterpart of ``benches/adder_ab_probe.py``: the 8-bit ``FheUint`` add at
a leading batch of 32 through the level-fused evaluator with every level
padded to 16 lanes (``ctx.circuit_fixed_width``), the two cells in turns
(``ctx.circuit_adder``: kogge_stone, ripple, kogge_stone, ripple), on a
latency-mode context.  A level's bootstrap batch is its 16 lanes times the
leading batch; K3 takes it when that is at most ``rotate_all_k.MAX_BATCH``,
else the K1 loop does, and each line names the kernel that ran.  All 32
sums must be right in every run.

Timing: the host clock around one add and its decryption (a readback), the
card synchronised before and after (``_timing.host_seconds``), after a
warm-up add.

Usage: python -m rustfhe_tpu_torch.benches.adder_ab_probe
"""

from __future__ import annotations

import sys

import numpy as np

from ..context import TFHE
from ..params import DEFAULT_PARAMS as P
from . import _timing

B = 32
WIDTH = 16  # lanes every level is padded to
ORDER = ("kogge_stone", "ripple", "kogge_stone", "ripple")


def run(out=print) -> dict[str, list[float]]:
    """{cell: seconds per add, each run} on the card."""
    device = _timing.require_cuda()
    ctx = TFHE.new(2, P, device=device, latency_mode=True)
    ctx.circuit_fixed_width = WIDTH
    out(f"# 8-bit FheUint add, B={B}, levels of {WIDTH} lanes, latency context "
        f"[{ctx.engine_name}] on {_timing.card()}")
    rng = np.random.default_rng(3)
    av = rng.integers(0, 256, size=B).astype(np.uint64)
    bv = rng.integers(0, 256, size=B).astype(np.uint64)
    times = {k: [] for k in ORDER}
    for kind in ORDER:
        ctx.circuit_adder = kind
        a, b = ctx.encrypt_uint(av, 8), ctx.encrypt_uint(bv, 8)
        s = a + b
        s.decrypt()  # warm-up
        got = []
        before = _timing.rotation_launches()
        dt = _timing.host_seconds(lambda: got.append((s + b).decrypt()))
        ok = int((np.asarray(got[0]) == ((av + 2 * bv) & 0xFF)).sum())
        if ok != B:
            raise AssertionError(f"adder8 [{kind}]: {ok}/{B} right")
        times[kind].append(dt)
        out(f"adder8 [{kind}]: {ok}/{B} correct, {dt * 1e3:.0f} ms per add "
            f"({_timing.ran(before)})")
    return times


def main(argv=None) -> int:
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
