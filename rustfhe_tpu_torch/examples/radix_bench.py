"""PBS_PARAMS and the radix integers on the card: validation and cost.

Port of ``examples/radix_bench.py``, with its sections, knobs and
assertions:

  1. PBS_PARAMS soundness: space-8 programmable bootstrapping at a large
     batch, chained twice; every lookup must decode right.
  2. A radix 8-bit add: correct at PBS_PARAMS, its cost in bootstrap
     levels and lookups (radix: 4 levels, 8 lookups; the bit circuit at the
     same preset: the default Kogge-Stone cell's 7 levels and 67 gate
     bootstraps, where the JAX script's text says 15 levels, the ripple
     cell's), with the times of both paths; then the radix 8-bit multiply
     (18 levels).
  3. ``pbs_many`` (space 8, t=2) at the radix batch: its decode errors
     counted (no assertion: the measurement of the borderline variant).
  4. Shifts (shl 2 free, shl 3 one PBS level, shr 3), the scalar multiply
     x10, ``add_overflows`` and the signed full-width product.

Usage (on a host with a CUDA card):

    python3 -m rustfhe_tpu_torch.examples.radix_bench

Knobs: ``BATCH`` (256, the radix ops' batch), ``PBS_BATCH`` (65536, the
space-8 PBS batch), ``KEYFILE`` (a path prefix for the raw-key cache of
``utils.serialization.cached_keys``; unset or empty: no cache, the keys
are made anew; the cache holds the secret key, so it goes where the user
says, never to a default path).  ``RUSTFHE_FORCE_CPU=1`` runs on the CPU
(the bench's device rule); its numbers mean nothing for the card.
Every timer synchronises the device.  The last line before ``OK`` gives
the allocator's peak device memory (``torch.cuda.max_memory_allocated``).
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import pbs, radix
from ..apps import circuits
from ..bench import bench_device, card_name
from ..context import TFHE
from ..params import PBS_PARAMS
from ..radix import RadixInt, RadixUint


M8 = np.uint64(0xFF)


def _bit_add(o):
    """The bit-circuit add on the context's default adder cell, every level
    padded to width 16 (the widest level of the 8-bit adder)."""
    ctx = o.ua.ctx
    ctx.circuit_fixed_width = 16
    try:
        return o.ua + o.ub
    finally:
        del ctx.circuit_fixed_width


# The bench's 8-bit ops, which chip_smoke.py's phase 14 runs too: name ->
# (the op on the ciphertexts ``o``, numpy's value from the plaintexts
# ``v``).  ``o`` and ``v`` carry a, b (RadixUint; uint64), ua, ub (a and b
# as FheUint) and sa, sb (RadixInt; int64).
OPS = {
    "radix add8": (lambda o: o.a + o.b, lambda v: (v.a + v.b) & M8),
    "radix add8 chained, (a + b) + b": (lambda o: (o.a + o.b) + o.b,
                                        lambda v: (v.a + 2 * v.b) & M8),
    "bit-circuit add8": (_bit_add, lambda v: (v.a + v.b) & M8),
    "radix mul8": (lambda o: o.a * o.b, lambda v: (v.a * v.b) & M8),
    "radix shl2": (lambda o: o.a.shift_left(2), lambda v: (v.a << np.uint64(2)) & M8),
    "radix shl3": (lambda o: o.a.shift_left(3), lambda v: (v.a << np.uint64(3)) & M8),
    "radix shr3": (lambda o: o.a.shift_right(3), lambda v: v.a >> np.uint64(3)),
    "radix scalar x10": (lambda o: o.a * 10, lambda v: (v.a * np.uint64(10)) & M8),
    "radix add_overflows": (lambda o: o.a.add_overflows(o.b),
                            lambda v: np.stack([(v.a + v.b) & M8, (v.a + v.b) >> np.uint64(8)])),
    "radix SIGNED full-width mul8": (lambda o: o.sa.mul(o.sb, full=True),
                                     lambda v: v.sa * v.sb),
}


def decrypt(ctx, out) -> np.ndarray:
    """An op of ``OPS``'s output as numpy; ``add_overflows``'s (sum, carry
    flag) stacked."""
    if isinstance(out, tuple):
        return np.stack([out[0].decrypt(),
                         ctx.decrypt(out[1]).cpu().numpy().astype(np.uint64)])
    return out.decrypt()


def _timed(fn, device):
    """(fn(), seconds) with the device synchronised on both sides."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main() -> None:
    p = PBS_PARAMS
    B = int(os.environ.get("BATCH", "256"))
    BP = int(os.environ.get("PBS_BATCH", "65536"))
    device = bench_device()
    card = card_name(device)
    print(f"# device: {device} {card}", flush=True)
    ok, msg = pbs.check_pbs_space(p, 8)
    print(f"# preset check: {msg} -> ok={ok}", flush=True)
    assert ok, "PBS_PARAMS must pass space=8 at the 5-sigma bar"
    ok_r, msg_r = radix.check_radix(p)
    print(f"# {msg_r} -> ok={ok_r}", flush=True)
    assert ok_r
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    keyfile = os.environ.get("KEYFILE") or None
    ctx, dt_key = _timed(lambda: TFHE.new(11, p, device=device, keyfile=keyfile), device)
    print(f"# keygen {dt_key:.1f}s (engine {ctx.engine_name})", flush=True)
    rng = np.random.default_rng(5)

    def run(name):
        """Run ``OPS[name]`` on ``o``, timed: (output, seconds, values equal
        to numpy's, values)."""
        op, want = OPS[name]
        out, dt = _timed(lambda: op(o), device)
        w = want(v)
        return out, dt, int((decrypt(ctx, out) == w).sum()), w.size

    # ---- 1. space=8 PBS at a large batch: zero decode errors.
    space = 8
    xs = rng.integers(0, space, size=BP)
    table = rng.integers(0, space, size=(space,))
    ct = ctx.encrypt_int(xs, space)
    out, dt_c = _timed(lambda: ctx.apply_lut(ct, table, space), device)
    out, dt = _timed(lambda: ctx.apply_lut(out, table, space), device)  # chained second run
    dec = ctx.decrypt_int(out, space).cpu().numpy()
    want = table[table[xs]]  # chained g(g(x))
    n_ok = int((dec == want).sum())
    print(f"pbs space=8 B={BP}: {n_ok}/{BP} correct ({BP / dt:,.0f} PBS/s on {card}, "
          f"first call {dt_c:.1f}s)", flush=True)
    assert n_ok == BP, f"{BP - n_ok} decode errors at the PBS preset"
    del ct, out

    # ---- 2. radix 8-bit add: correctness and cost against the bit circuit.
    nd = 4  # 4 x 2-bit digits = 8 bits
    v = SimpleNamespace(a=rng.integers(0, 256, size=B).astype(np.uint64),
                        b=rng.integers(0, 256, size=B).astype(np.uint64))
    o = SimpleNamespace(a=RadixUint.encrypt(ctx, v.a, nd), b=RadixUint.encrypt(ctx, v.b, nd))
    _, _, n_ok, _ = run("radix add8")
    _, dt2, n_ok2, _ = run("radix add8 chained, (a + b) + b")  # two adds
    dt_radix = dt2 / 2
    print(f"radix add8 B={B}: {n_ok}/{B} correct, {dt_radix * 1e3:.0f} ms per add "
          f"({nd} bootstrap levels, {2 * nd} PBS lookups) on {card}", flush=True)
    assert n_ok == B and n_ok2 == B

    # The bit-circuit add at the same preset, on the context's default adder
    # cell; timed on its second call (the first pays the device's warm-up).
    cell = circuits.kogge_stone_adder(8)
    o.ua, o.ub = ctx.encrypt_uint(v.a, 8), ctx.encrypt_uint(v.b, 8)
    _, dt_bits_c, n_ok, _ = run("bit-circuit add8")
    _, dt_bits, _, _ = run("bit-circuit add8")
    print(f"bit-circuit add8 B={B}: {n_ok}/{B} correct, {dt_bits * 1e3:.0f} ms per add "
          f"({cell.depth} levels; first call {dt_bits_c:.1f}s) on {card}", flush=True)
    assert n_ok == B
    print(f"=> radix vs bit-circuit: {dt_bits / dt_radix:.2f}x wall-time, bootstrap levels "
          f"{cell.depth} -> {nd}, lookups {len(cell.gates)} -> {2 * nd}", flush=True)

    # ---- 2b. radix 8-bit multiply (18 bootstrap levels), timed on its second call.
    ok_mul, msg_mul = radix.check_radix_mul(p)
    print(f"# {msg_mul} -> ok={ok_mul}", flush=True)
    _, _, n_ok, _ = run("radix mul8")
    _, dt_mul, _, _ = run("radix mul8")
    print(f"radix mul8 B={B}: {n_ok}/{B} correct, {dt_mul * 1e3:.0f} ms per multiply "
          f"(18 bootstrap levels) on {card}", flush=True)
    assert n_ok == B

    # ---- 3. the pbs_many(8, 2) variant, its decode errors counted.
    ok_m, msg_m = pbs.check_pbs_many(p, 8, 2)
    print(f"# {msg_m} -> ok={ok_m}", flush=True)
    tabs = rng.integers(0, space, size=(2, space))
    ctm = ctx.encrypt_int(xs[:B], space)
    outm, _ = _timed(lambda: ctx.apply_luts(ctm, tabs, space), device)
    decm = ctx.decrypt_int(outm, space).cpu().numpy()
    bad = sum(int((decm[:, j] != tabs[j][xs[:B]]).sum()) for j in range(2))
    print(f"pbs_many(8,2) B={B}: {2 * B - bad}/{2 * B} correct "
          f"(margin {msg_m.split('margin ')[1]})", flush=True)

    # ---- 4. shifts: even amounts free (digit re-index), odd amounts 1 level.
    for k in (2, 3):
        _, dt_sh, n_ok, _ = run(f"radix shl{k}")
        print(f"radix shl{k} B={B}: {n_ok}/{B} correct, {dt_sh * 1e3:.0f} ms "
              f"({'1 PBS level' if k % 2 else 'free'}) on {card}", flush=True)
        assert n_ok == B
    _, dt_sr, n_ok, _ = run("radix shr3")
    print(f"radix shr3 B={B}: {n_ok}/{B} correct, {dt_sr * 1e3:.0f} ms on {card}", flush=True)
    assert n_ok == B

    # The scalar multiply: x10 = the shared odd shift + one add round.
    _, dt_sm, n_ok, _ = run("radix scalar x10")
    print(f"radix scalar x10 B={B}: {n_ok}/{B} correct, {dt_sm * 1e3:.0f} ms (5 levels vs "
          f"the general multiply's 18, measured {dt_mul * 1e3:.0f} ms above) on {card}",
          flush=True)
    assert n_ok == B

    # Overflow flags and the signed full-width product.
    _, _, n_ok, n = run("radix add_overflows")
    print(f"radix add_overflows B={B}: {n_ok}/{n} sums and carry flags correct", flush=True)
    assert n_ok == n

    v.sa = rng.integers(-128, 128, size=B).astype(np.int64)
    v.sb = rng.integers(-128, 128, size=B).astype(np.int64)
    o.sa, o.sb = RadixInt.encrypt(ctx, v.sa, nd), RadixInt.encrypt(ctx, v.sb, nd)
    _, dt_sf, n_ok, _ = run("radix SIGNED full-width mul8")
    print(f"radix SIGNED full-width mul8 B={B}: {n_ok}/{B} correct, {dt_sf * 1e3:.0f} ms "
          f"(52 levels) on {card}", flush=True)
    assert n_ok == B

    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        print(f"# peak device memory (allocator): {peak / 2**30:.3f} GiB on {card}", flush=True)
    print("OK", flush=True)


if __name__ == "__main__":
    main()
