"""The console's pipelined mode: sustained ms per expression.

Counterpart of ``benches/pipeline_repl_probe.py``.  A console line of K
expressions separated by ';' runs through
``apps.replprog.FusedEvaluator.eval_bits``: the K expressions lower into
one shared wire file, run as depth(combined DAG) bootstrap batches, and
all K roots are decrypted in one readback.  This measures the sustained
ms per expression for K = 1, 4 and 8 single-gate expressions on the
latency key (``keys.cloud_key_latency``: K3, one launch per bootstrap
batch), each session checked against WANT, beside the reference's 30.6 ms
console answer (``nander/src/main.rs:56-63``).

The nonce wire stays: ``eval_bits`` takes ``_nonce`` (words in the trash
wire's mask, result-neutral), and each session passes a new one.
``PROBE_ITERS`` sets the sessions per K (10).  Timing: the host clock over
ITERS sessions in a row, each ending in its readback, the card
synchronised before and after (``_timing.host_seconds``).

Usage: python -m rustfhe_tpu_torch.benches.pipeline_repl_probe
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import keys
from ..apps import nander
from ..apps.replprog import FusedEvaluator
from ..context import TFHE
from ..engine import select_fast_engine
from ..params import DEFAULT_PARAMS as P
from . import _timing
from .repl_latency_probe import REFERENCE_MS, iters

# K single-gate expressions per session; results checked every call.
EXPRS = ["1 $ 0", "1 & 1", "0 | 0", "1 ^ 0", "0 $ 0", "1 & 0", "1 | 0", "1 ^ 1"]
WANT = [1, 1, 0, 1, 1, 0, 1, 0]
SESSIONS = (1, 4, 8)


def run(out=print) -> dict[int, float]:
    """{K: seconds per expression, sustained} on the card, over
    ``PROBE_ITERS`` sessions each."""
    device = _timing.require_cuda()
    n = iters()
    eng = select_fast_engine(P, device)
    gen = torch.Generator(device=device).manual_seed(0)
    sk, ck = keys.gen_keys(gen, P, device, eng)
    ev = FusedEvaluator(TFHE(sk, keys.cloud_key_latency(ck), P, device, engine_name=eng))
    out(f"# pipelined console sessions on {_timing.card()} [{eng}, latency key]  iters={n}")
    rs = np.random.RandomState(0)
    times = {}
    for K in SESSIONS:
        asts = [nander.parse_logic_expr(e) for e in EXPRS[:K]]

        def session():
            got = ev.eval_bits(asts, _nonce=rs.randint(0, 2**31, P.n))
            if got != WANT[:K]:
                raise AssertionError(f"pipelined session K={K} gave {got}, expected {WANT[:K]}")

        session()
        before = _timing.rotation_launches()
        dt = _timing.host_seconds(session, n)
        times[K] = dt / K
        out(f"pipelined session K={K}: {dt * 1e3:.2f} ms wall -> {dt / K * 1e3:.2f} "
            f"ms/expression sustained ({dt / K * 1e3 / REFERENCE_MS:.2f}x the reference's "
            f"{REFERENCE_MS} ms console answer; {_timing.ran(before)} in {n} sessions)")
    return times


def main(argv=None) -> int:
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
