"""Typed encrypted integers end to end: a batch of FheUint8 values is added,
multiplied, divided, compared and min-selected entirely under encryption
through the ``ints`` API (every op a standard-cell circuit, level-fused,
one batched bootstrap per level), then decode-asserted against numpy.

Port of ``examples/encrypted_ints.py``, with its knobs and assertions.  The
JAX script pads every circuit level to one width at DEFAULT_PARAMS
(``circuit_fixed_width = 64``) so that one compiled program serves every
level; the port compiles nothing per shape, so its levels keep their
bucketed widths: at 256 pairs the padding would bootstrap 4x the lanes
(966,656 against 221,184 for the divide).  Times synchronise the device and
stand beside the card's name and power limit.
``RUSTFHE_FORCE_CPU=1`` runs it on the CPU.  Usage:

    python3 -m rustfhe_tpu_torch.examples.encrypted_ints [batch=256] [bits=8] [params]

``params``: default | test (test: small parameters, quick on the CPU).
"""

from __future__ import annotations

import sys

import numpy as np

from ..bench import bench_device, card_name
from ..context import TFHE
from ..ints import FheInt
from ..params import DEFAULT_PARAMS, TEST_PARAMS
from ..utils.timing import time_fn


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if len(argv) > 0 else 256
    bits = int(argv[1]) if len(argv) > 1 else 8
    params = TEST_PARAMS if (len(argv) > 2 and argv[2] == "test") else DEFAULT_PARAMS
    mask = (1 << bits) - 1
    device = bench_device()
    card = card_name(device)

    dt, ctx = time_fn(lambda: TFHE.new(11, params, device=device), iters=1, warmup=0,
                      device=device)
    print(f"# keygen: {dt:.1f}s  (n={params.n}, N={params.N}, engine {ctx.engine_name}) "
          f"on {card}", flush=True)

    rs = np.random.RandomState(5)
    av = rs.randint(0, 1 << bits, size=batch).astype(np.uint64)
    bv = rs.randint(0, 1 << bits, size=batch).astype(np.uint64)
    a = ctx.encrypt_uint(av, bits)
    b = ctx.encrypt_uint(bv, bits)

    def check(tag, op, expect):
        dt, fhe = time_fn(op, iters=1, warmup=0, device=device)
        got = (fhe.decrypt() if hasattr(fhe, "decrypt")
               else ctx.decrypt(fhe).cpu().numpy().astype(np.uint64))
        ok = int(np.sum(got == expect))
        print(f"# {tag:>10}: {ok}/{batch} correct  ({dt:.2f}s on {card})", flush=True)
        assert ok == batch, f"{tag}: {batch - ok} wrong"

    check("a + b", lambda: a + b, (av + bv) & mask)
    check("a * b", lambda: a * b, (av * bv) & mask)
    check("a < b", lambda: a.lt(b), (av < bv).astype(np.uint64))
    check("min", lambda: a.min_(b), np.minimum(av, bv))
    dt, (q, r) = time_fn(a.divmod, b, iters=1, warmup=0, device=device)
    print(f"# {'divmod':>10}: {dt:.2f}s on {card}", flush=True)
    safe = np.where(bv == 0, 1, bv)
    check("a // b", lambda: q, np.where(bv == 0, mask, av // safe))
    check("a % b", lambda: r, np.where(bv == 0, av, av % safe))

    # signed: compare across the sign boundary + wrapping abs
    sv = av.astype(np.int64) - (1 << (bits - 1))
    s = FheInt.encrypt(ctx, sv, bits)
    exp_abs = np.abs(sv)
    exp_abs[sv == -(1 << (bits - 1))] = -(1 << (bits - 1))
    check("abs(s)", lambda: s.abs_(), exp_abs)
    print("# all integer ops decode correctly", flush=True)


if __name__ == "__main__":
    main()
