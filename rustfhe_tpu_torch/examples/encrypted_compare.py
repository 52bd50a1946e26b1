"""Encrypted integer comparison: a batch of (a, b) pairs compared entirely
under encryption with the n-bit comparator standard cell (lt / eq / gt
outputs), and an encrypted a - b through the ripple-borrow subtractor, all
through the level-fused circuit evaluator.

Port of ``examples/encrypted_compare.py``, with its knobs and assertions.
Times synchronise the device and stand beside the card's name and power
limit.  ``RUSTFHE_FORCE_CPU=1`` runs it on the CPU.  Usage:

    python3 -m rustfhe_tpu_torch.examples.encrypted_compare [batch=256] [bits=8] [params]

``params``: default | test (test: small parameters, quick on the CPU).
"""

from __future__ import annotations

import sys

import numpy as np

from ..apps.circuits import comparator, evaluate_encrypted, evaluate_plain, ripple_borrow_subtractor
from ..bench import bench_device, card_name
from ..context import TFHE
from ..params import DEFAULT_PARAMS, TEST_PARAMS
from ..utils.timing import time_fn


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if len(argv) > 0 else 256
    bits = int(argv[1]) if len(argv) > 1 else 8
    params = TEST_PARAMS if (len(argv) > 2 and argv[2] == "test") else DEFAULT_PARAMS
    device = bench_device()
    card = card_name(device)

    cmp_c = comparator(bits)
    sub_c = ripple_borrow_subtractor(bits)
    print(f"# comparator: {len(cmp_c.gates)} gates, depth {cmp_c.depth}; "
          f"subtractor: {len(sub_c.gates)} gates, depth {sub_c.depth}", flush=True)

    # engine: the JAX package's accelerator rule, admitted by its probe
    dt, ctx = time_fn(lambda: TFHE.new(7, params, device=device), iters=1, warmup=0,
                      device=device)
    print(f"# keygen: {dt:.1f}s  (n={params.n}, N={params.N}, engine {ctx.engine_name}) "
          f"on {card}", flush=True)

    rs = np.random.RandomState(3)
    a = rs.randint(0, 1 << bits, size=batch)
    b = rs.randint(0, 1 << bits, size=batch)
    bits_in = np.zeros((batch, 2 * bits), np.int32)
    for i in range(bits):
        bits_in[:, i] = (a >> i) & 1
        bits_in[:, bits + i] = (b >> i) & 1

    cts = ctx.encrypt(bits_in)

    dt, dec = time_fn(lambda: ctx.decrypt(evaluate_encrypted(cmp_c, ctx, cts)).cpu().numpy(),
                      iters=1, warmup=0, device=device)
    lt, eq, gt = (dec[:, k] for k in range(3))
    assert np.array_equal(lt, (a < b).astype(np.int32))
    assert np.array_equal(eq, (a == b).astype(np.int32))
    assert np.array_equal(gt, (a > b).astype(np.int32))
    total = len(cmp_c.gates) * batch
    print(f"# comparator: {batch} encrypted comparisons correct in {dt:.1f}s "
          f"({total / dt:,.0f} gate-evals/s on {card})", flush=True)

    dt, dec = time_fn(lambda: ctx.decrypt(evaluate_encrypted(sub_c, ctx, cts)).cpu().numpy(),
                      iters=1, warmup=0, device=device)
    diff = sum(dec[:, i].astype(np.int64) << i for i in range(bits))
    assert np.array_equal(diff, (a - b) % (1 << bits))
    assert np.array_equal(dec[:, bits], (a < b).astype(np.int32))
    print(f"# subtractor: {batch} encrypted subtractions correct in {dt:.1f}s on {card}",
          flush=True)
    # cross-check the plain evaluator too
    assert np.array_equal(np.asarray(evaluate_plain(cmp_c, bits_in))[:, 0], lt)
    print("ok", flush=True)


if __name__ == "__main__":
    main()
