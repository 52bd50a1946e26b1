"""Encrypted 8-bit ripple-carry adder at production parameters: a levelled
multi-gate circuit over encrypted bits, with a batch of additions riding
through every bootstrapped gate.

Port of ``examples/adder_bench.py`` (BASELINE.json's configs 3 and 4), at
DEFAULT_PARAMS on the engine the JAX package's accelerator rule names (K1
at DEFAULT).  The latency rule is JAX's: a latency-mode context when
``batch * 4 <= 16384``.  On the port a latency key costs no memory and runs
the single-launch rotation K3 only on levels of at most
``rotate_all_k.MAX_BATCH`` (64) lanes at a shape K3 takes
(``rotate_all_k.takes``), and the K1 loop above that: the script prints
which one each level ran (a latency key is marked only on the K1-K3
engine's key), and on the card the launch counts.  The time
synchronises the device and stands beside the card's name and power
limit; as in the JAX script it includes the first call's warm-up.
``RUSTFHE_FORCE_CPU=1`` runs it on the CPU.  Usage:

    python3 -m rustfhe_tpu_torch.examples.adder_bench [batch=256] [bits=8]
"""

from __future__ import annotations

import sys

import numpy as np

from ..apps.circuits import evaluate_encrypted, ripple_carry_adder
from ..bench import bench_device, card_name
from ..context import TFHE
from ..engine import cmux_k, rotate_all_k
from ..keys import LatencyBK
from ..params import DEFAULT_PARAMS
from ..utils.timing import time_fn


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if len(argv) > 0 else 256
    bits = int(argv[1]) if len(argv) > 1 else 8
    device = bench_device()
    card = card_name(device)
    p = DEFAULT_PARAMS

    circuit = ripple_carry_adder(bits)
    n_gates = len(circuit.gates)
    print(f"{bits}-bit adder: {n_gates} gates, depth {circuit.depth}", flush=True)

    # Latency mode (the single-launch rotation K3) wins for small level
    # batches; each level fuses up to max-same-op-gates-per-level x batch
    # ciphertexts, so it is gated as the JAX script gates it.
    latency = batch * 4 <= 16384  # the widest same-op adder level bucket is < 4
    dt, ctx = time_fn(lambda: TFHE.new(0, p, device=device, latency_mode=latency),
                      iters=1, warmup=0, device=device)
    print(f"keygen: {dt:.1f}s (engine {ctx.engine_name}, latency_mode={latency}) on {card}",
          flush=True)

    rs = np.random.RandomState(0)
    a = rs.randint(0, 1 << bits, size=batch)
    b = rs.randint(0, 1 << bits, size=batch)
    in_bits = np.zeros((batch, 2 * bits), np.int32)
    for i in range(bits):
        in_bits[:, i] = (a >> i) & 1
        in_bits[:, bits + i] = (b >> i) & 1

    cts = ctx.encrypt(in_bits)  # (batch, 2*bits, n+1)

    lanes = []  # the lanes of every bootstrap call, one call per level
    boot = ctx.bootstrap_raw

    def counted(pre):
        lanes.append(pre[..., 0].numel())
        return boot(pre)

    ctx.bootstrap_raw = counted
    k1_0, k3_0 = cmux_k.cmux_step.launches, rotate_all_k.rotate_all.launches
    dt, out = time_fn(evaluate_encrypted, circuit, ctx, cts, iters=1, warmup=0)
    del ctx.bootstrap_raw
    dec = ctx.decrypt(out).cpu().numpy()  # (batch, bits+1)

    total = np.zeros(batch, np.int64)
    for i in range(bits + 1):
        total |= dec[:, i].astype(np.int64) << i
    ok = np.array_equal(total, a + b)
    gate_evals = n_gates * batch
    print(f"{'OK' if ok else 'FAIL'}: {batch} additions in {dt:.2f}s "
          f"({gate_evals} bootstrapped gate-evals, {gate_evals / dt:,.0f} gates/s, "
          f"incl. warm-up) on {card}", flush=True)
    # bootstrap.blind_rotate's rule for a call of n lanes
    k3_key = isinstance(ctx.ck.bk, LatencyBK) and rotate_all_k.takes(p)
    on_k3 = sum(k3_key and n <= rotate_all_k.MAX_BATCH for n in lanes)
    launches = (f"launches: K3 {rotate_all_k.rotate_all.launches - k3_0}, K1 "
                f"{cmux_k.cmux_step.launches - k1_0} steps" if device.type == "cuda"
                else "the kernels' plain versions on the CPU")
    print(f"blind rotations: {len(lanes)} levels of {min(lanes)}-{max(lanes)} lanes; "
          f"{on_k3} on K3 (one launch each), {len(lanes) - on_k3} on the step loop "
          f"({p.n} steps each; K1's on a K1-K3 key); {launches}", flush=True)
    assert ok, "encrypted addition mismatch"


if __name__ == "__main__":
    main()
