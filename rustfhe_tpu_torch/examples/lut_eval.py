"""Programmable bootstrapping demo: homomorphic lookup-table evaluation.

Port of ``examples/lut_eval.py``: functions f: Z_space -> Z_space on
encrypted integers, ONE bootstrap each (``pbs``), on the blind-rotation
kernels of the gates (K1 at DEFAULT_PARAMS):

  1. a fixed function (squaring mod space) for the whole batch, timed;
  2. a RANDOM function per row (a table per ciphertext, one pass);
  3. a chained pair g(f(x)): outputs are valid fresh inputs;
  4. multi-output PBS (``apply_luts``): t tables from one rotation, timed;
  5. the PBS -> bit bridge (``int_to_uint``) at its borderline margin.

Every decode is asserted against the cleartext table before a time is
reported; times synchronise the device and stand beside the card's name
and power limit.  ``KEYFILE``: a path prefix for the raw-key cache
(``utils.serialization.cached_keys``); unset or empty: no cache (the cache
holds the secret key, so it goes only where the user says).  The JAX
script's XLA compilation cache has no counterpart here: the kernels'
nvcc libraries are kept by source hash in ``rustfhe_tpu_torch/build/``.
``RUSTFHE_FORCE_CPU=1`` runs it on the CPU.  Usage:

    python3 -m rustfhe_tpu_torch.examples.lut_eval [--space 4] [--batch 4096] [--params default]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import pbs
from ..bench import bench_device, card_name
from ..context import TFHE
from ..params import DEFAULT_PARAMS, TEST_PARAMS
from ..utils.timing import time_fn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--space", type=int, default=4,
                    help="message space (power of two; noise-checked: at the reference "
                         "parameter set space=4 is as sound as the gates)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--params", choices=["default", "test"], default="default")
    args = ap.parse_args(argv)
    p = {"default": DEFAULT_PARAMS, "test": TEST_PARAMS}[args.params]
    space, B = args.space, args.batch

    ok, msg = pbs.check_pbs_space(p, space, min_sigmas=4.0)
    print(f"# noise budget: {msg}" + ("" if ok else "  [UNSOUND — refusing]"), flush=True)
    if not ok:
        sys.exit(1)

    device = bench_device()
    card = card_name(device)
    print(f"# device: {device} {card}", flush=True)
    keyfile = os.environ.get("KEYFILE") or None
    dt, ctx = time_fn(lambda: TFHE.new(0, p, device=device, keyfile=keyfile), iters=1,
                      warmup=0, device=device)
    print(f"# keygen ({ctx.engine_name}): {dt:.1f}s on {card}", flush=True)

    rng = np.random.default_rng(0)
    xs = rng.integers(0, space, size=(B,))
    ct = ctx.encrypt_int(xs, space)

    def dec(out, s=space):
        return ctx.decrypt_int(out, s).cpu().numpy()

    # 1. one function for the whole batch: squaring mod space
    sq = np.array([(v * v) % space for v in range(space)])
    dt, out = time_fn(ctx.apply_lut, ct, sq, space, iters=1, warmup=0)
    print(f"# first PBS batch: {dt:.1f}s on {card}", flush=True)
    assert np.array_equal(dec(out), sq[xs]), "square LUT wrong"
    dt, _ = time_fn(ctx.apply_lut, ct, sq, space, iters=1, warmup=0)
    print(f"# x^2 mod {space}: {B} lookups correct, {dt * 1e3:.0f} ms "
          f"-> {B / dt:,.0f} PBS/s on {card}", flush=True)

    # 2. multi-LUT: a different random function per row, same pass
    tables = rng.integers(0, space, size=(B, space))
    out = ctx.apply_lut(ct, tables, space)
    assert np.array_equal(dec(out), tables[np.arange(B), xs]), "multi-LUT wrong"
    print(f"# multi-LUT: {B} distinct random functions correct in one pass", flush=True)

    # 3. chaining: g(f(x)), PBS outputs are valid fresh inputs
    f = rng.permutation(space)
    g = rng.permutation(space)
    out = ctx.apply_lut(ctx.apply_lut(ct, f, space), g, space)
    assert np.array_equal(dec(out), g[f[xs]])
    print(f"# chained g(f(x)): {B} correct through two bootstraps", flush=True)

    # 4. multi-output PBS (PBSmanyLUT): t tables, ONE blind rotation.
    # space*t fixes the sub-slot resolution; at the default set t=2 at
    # space=2 is noise-sound (check_pbs_many).
    t_many = 2
    space_m = 2
    ok, msg = pbs.check_pbs_many(p, space_m, t_many, min_sigmas=4.0)
    print(f"# noise budget: {msg}" + ("" if ok else "  [UNSOUND — skipping]"), flush=True)
    if ok:
        xs_m = rng.integers(0, space_m, size=(B,))
        ct_m = ctx.encrypt_int(xs_m, space_m)
        tabs = rng.integers(0, space_m, size=(t_many, space_m))
        ctx.apply_luts(ct_m, tabs, space_m)
        dt, out = time_fn(ctx.apply_luts, ct_m, tabs, space_m, iters=1, warmup=0)
        got = dec(out, space_m)
        for j in range(t_many):
            n_ok = int(np.sum(got[:, j] == tabs[j][xs_m]))
            print(f"# manyLUT table {j}: {n_ok}/{B} correct", flush=True)
            assert n_ok == B, f"manyLUT table {j}: {B - n_ok} wrong"
        print(f"# manyLUT: {t_many}x{B} lookups from {B} rotations, {dt * 1e3:.0f} ms "
              f"-> {t_many * B / dt:,.0f} lookups/s on {card}", flush=True)

    # 5. PBS -> bit bridge: decompose a PBS-domain int into gate-encoded
    # FheUint bit planes (one bootstrap), then read them back.
    space_b = 4
    ok, msg = pbs.check_pbs_many(p, space_b, 2, min_sigmas=4.0)
    print(f"# noise budget: {msg}" + ("" if ok else "  [UNSOUND — skipping]"), flush=True)
    if ok:
        xs_b = rng.integers(0, space_b, size=(B,))
        ct_b = ctx.encrypt_int(xs_b, space_b)
        # unsafe=True: this section IS the borderline-margin measurement of
        # the single-rotation t=2 form (4.2 predicted sigma, below the
        # 5-sigma API gate); without it the bridge splits into per-bit
        # rotations that each pass the check.
        u = ctx.int_to_uint(ct_b, space_b, unsafe=True)
        n_ok = int(np.sum(u.decrypt() == xs_b))
        print(f"# int_to_uint: {n_ok}/{B} bit decompositions correct (margin is borderline "
              f"at space=4 x t=2 — also a noise measurement)", flush=True)
        assert n_ok >= int(0.99 * B), f"bridge: {B - n_ok} wrong (> 1%)"
    print("OK", flush=True)


if __name__ == "__main__":
    main()
