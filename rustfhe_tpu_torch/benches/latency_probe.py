"""The latency of one NAND bootstrap batch at small and large B.

Counterpart of ``benches/latency_probe.py``.  A whole batch shares the n
CMux steps, so the time of one batch is the number a circuit level of B
gates pays, and the time per gate divides it by B; the reference's single
gate takes 30.6 ms on one CPU core (``BASELINE.md``).

At each B the batch runs on the standard key (the K1 loop) and on the
latency key (``keys.cloud_key_latency``: K3, one launch per rotation,
where ``rotate_all_k.takes`` holds and the batch is at most
``rotate_all_k.MAX_BATCH``, else the K1 loop); each line names the
kernel that ran.  Every output is decrypted and checked, and the latency
key's output must equal the standard key's word for word.  The JAX script
treats 32768 as an out-of-memory boundary of its chip; here it is one more
batch.  Timing: each batch alone on the host clock, the card synchronised
before and after (``utils.timing.time_fn``), the best of ITERS.

Usage: python -m rustfhe_tpu_torch.benches.latency_probe
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import gates, keys, tlwe
from ..engine import select_fast_engine
from ..params import DEFAULT_PARAMS as P
from ..utils.timing import time_fn
from . import _timing

BATCHES = (128, 1024, 8192, 16384, 32768)
ITERS = 5


def run(batches=BATCHES, iters: int = ITERS, iters_largest: int | None = None,
        out=print) -> dict[tuple[int, str], float]:
    """Check and time a NAND batch at each B on the card, on both keys;
    {(B, key): seconds per batch}.  ``iters_largest`` times the largest B
    fewer times (default ``iters``)."""
    device = _timing.require_cuda()
    out(f"# NAND batch latency on {_timing.card()}  iters={iters}")
    eng = select_fast_engine(P, device)
    gen = torch.Generator(device=device).manual_seed(0)
    sk, ck = keys.gen_keys(gen, P, device, eng)
    keyset = (("standard", ck), ("latency", keys.cloud_key_latency(ck)))
    out(f"# engine: {eng}; latency key: no panel tables, K3 reads the standard key")
    times = {}
    for B in batches:
        rs = np.random.RandomState(B)
        bx, by = (torch.from_numpy(rs.randint(0, 2, size=B).astype(np.int32)).to(device)
                  for _ in range(2))
        cx, cy = (tlwe.encrypt_binary(gen, sk.lv0, b, P) for b in (bx, by))
        pre = gates.precombine("nand", cx, cy, params=P)
        want = None
        for tag, key in keyset:
            before = _timing.rotation_launches()
            got = gates.hom_bootstrap(key, pre, params=P, engine_name=eng)
            kernel = _timing.ran(before)
            bad = int((tlwe.decrypt_binary(got, sk.lv0) != 1 - (bx & by)).sum())
            if bad:
                raise AssertionError(f"B={B} [{tag}]: {bad} wrong")
            if want is not None and not torch.equal(got, want):
                raise AssertionError(f"B={B}: the latency key's output differs")
            want = got
            n = iters_largest if (iters_largest is not None and B == max(batches)) else iters
            best, _ = time_fn(lambda: gates.hom_bootstrap(key, pre, params=P, engine_name=eng),
                              iters=n, warmup=0, device=device)
            times[(B, tag)] = best
            out(f"B={B:6d} [{tag:8s}]: {best * 1e3:8.1f} ms/batch  ({best / B * 1e3:7.3f} "
                f"ms/gate amortized, {B / best:,.0f} gates/s; best of {n}; {kernel}; "
                f"all {B} right)")
    return times


def main(argv=None) -> int:
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
