"""Gate check harness: keygen and the truth table of every gate, with each
gate's time.

Port of ``examples/homnand_bench.py`` (the analogue of the reference's
``homnand-bench`` example): each gate's whole truth table, ``reps`` times
over, is one batched call through ``gates.GATES_2IN`` and ``gates.hom_not``
at DEFAULT_PARAMS, on the engine that ``engine.select_fast_engine`` admits
(K1 at DEFAULT).  Every time synchronises the device and stands beside the
card's name and power limit; the first gate's time includes the device's
warm-up, as the JAX script's includes its compile.  ``RUSTFHE_FORCE_CPU=1``
runs it on the CPU.  Usage:

    python3 -m rustfhe_tpu_torch.examples.homnand_bench [reps=1]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import gates, keys, tlwe
from ..bench import bench_device, card_name
from ..engine import select_fast_engine
from ..params import DEFAULT_PARAMS as P
from ..utils.timing import time_fn

TRUTH = {
    "nand": lambda x, y: 1 - (x & y),
    "and": lambda x, y: x & y,
    "or": lambda x, y: x | y,
    "xor": lambda x, y: x ^ y,
}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 1
    device = bench_device()
    card = card_name(device)

    # the engine the JAX package's accelerator rule names, admitted by its probe
    engine_name = select_fast_engine(P, device)
    print(f"engine: {engine_name} on {device} ({card})", flush=True)
    print("generating keys...", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    dt, (sk, ck) = time_fn(keys.gen_keys, gen, P, device, engine_name, iters=1, warmup=0,
                           device=device)
    print(f"keygen: {dt:.2f}s on {card}", flush=True)

    pat = np.tile(np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.int32), (reps, 1))
    x = torch.from_numpy(pat[:, 0]).to(device)
    y = torch.from_numpy(pat[:, 1]).to(device)
    cx = tlwe.encrypt_binary(gen, sk.lv0, x, P)
    cy = tlwe.encrypt_binary(gen, sk.lv0, y, P)

    for name, fn in gates.GATES_2IN.items():
        dt, out = time_fn(lambda: fn(ck, cx, cy, params=P, engine_name=engine_name),
                          iters=1, warmup=0, device=device)
        dec = tlwe.decrypt_binary(out, sk.lv0).cpu().numpy()
        ok = np.array_equal(dec, TRUTH[name](pat[:, 0], pat[:, 1]))
        print(f"{name:5s} {'OK ' if ok else 'FAIL'} {dt * 1e6:12,.0f} us "
              f"({len(pat)} gates, {len(pat) / dt:,.0f} gates/s on {card})", flush=True)
        assert ok, f"{name} truth table mismatch"

    # NOT
    cn = tlwe.encrypt_binary(gen, sk.lv0, x, P)
    dt, out = time_fn(lambda: gates.hom_not(ck, cn, params=P, engine_name=engine_name),
                      iters=1, warmup=0, device=device)
    dec = tlwe.decrypt_binary(out, sk.lv0).cpu().numpy()
    ok = np.array_equal(dec, 1 - pat[:, 0])
    print(f"not   {'OK ' if ok else 'FAIL'} {dt * 1e6:12,.0f} us on {card}", flush=True)
    assert ok


if __name__ == "__main__":
    main()
