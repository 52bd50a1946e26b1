"""The grouped (multi-bit, k=2) blind rotation, built exactly and timed.

Counterpart of ``benches/multibit_probe.py``.  Key bits are grouped in
pairs so that the rotation runs n/2 steps:

  X^{a0 s0 + a1 s1} = 1 + s0 m0 + s1 m1 + s0 s1 m0 m1,   m_j = X^{a_j} - 1

so with B0 = TRGSW(s0), B1 = TRGSW(s1), B01 = TRGSW(s0 s1) one group step
is acc + m0 (B0 . acc) + m1 (B1 . acc) + m0 m1 (B01 . acc), the three
external products sharing one gadget decomposition of acc, and each m_T a
rotation and a subtraction of the product.  It costs 3 products for 2 key
bits (x1.5 the products per bit), and the noise of each term is convolved
by m_T (x4 the blind-rotate variance per pair).

The products run on the engine named: ``"matmul"`` (the int8 GEMM of P9,
``engine.matmul``), as the JAX script runs them, or ``"cmux_k"`` (K2,
``cmux_k.external_product``, on the doubled key table).

``check_correctness`` decrypts a grouped NAND truth table on the card, or
on the CPU where the caller names it.
``main_timing`` times, on the card, the standard scan (one rotation,
difference, decomposition and product per bit) against the grouped scan
over the same 16 key bits at batch B on each engine, as chains whose
output feeds the next call, between CUDA events (``_timing.chain``).

Usage: python -m rustfhe_tpu_torch.benches.multibit_probe check [--cpu]
       python -m rustfhe_tpu_torch.benches.multibit_probe [B]     (the card)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import _u32, gates, keys, poly, tlwe, trgsw, trlwe
from .._device import resolve_device
from ..bootstrap import identity_key_switch, rotation_start
from ..engine import cmux_k, get_engine, plain
from ..params import DEFAULT_PARAMS, TEST_PARAMS, TFHEParams
from ..utils.noise import noise_budget
from . import _timing
from ._timing import Case
from .k2_floor_probe import macs

DEFAULT_B = 8192
BITS = 16  # key bits per timed scan: 8 grouped steps against 16 standard ones
ENGINES = ("matmul", "cmux_k")


# --------------------------------------------------------------------- #
# The engines' key tables and products
# --------------------------------------------------------------------- #
def prepare(rows: torch.Tensor, params: TFHEParams, engine: str) -> torch.Tensor:
    """TRGSW rows int32 (..., 2L, 2, N) -> the engine's table."""
    if engine == "cmux_k":
        return plain.prepare_trgsw(rows)
    return get_engine(engine).prepare_trgsw(rows, params)


def external_product(prepared: torch.Tensor, digits: torch.Tensor, params: TFHEParams,
                     engine: str) -> torch.Tensor:
    """One TRGSW's product with the digits (..., 2L, N) -> (..., 2, N)."""
    if engine != "cmux_k":
        return get_engine(engine).external_product_digits(prepared, digits, params)
    lead = digits.shape[:-2]
    d = digits.reshape(-1, 2 * params.l, params.N).to(torch.int8).contiguous()
    return cmux_k.external_product(d, prepared, params).reshape(lead + (2, params.N))


# --------------------------------------------------------------------- #
# The grouped key and rotation
# --------------------------------------------------------------------- #
def gen_grouped_bk(gen: torch.Generator, sk: keys.SecretKey, params: TFHEParams,
                   engine: str = "matmul"):
    """(bkg, bk_last): bkg the engine's tables (n//2, 3, ...) of each pair
    (s_even, s_odd, s_even * s_odd); bk_last (1, ...) TRGSW(s_{n-1}) when
    n is odd, else None."""
    s0 = sk.lv0
    g = params.n // 2
    se, so = s0[: 2 * g: 2], s0[1: 2 * g: 2]
    items = torch.stack([se, so, se * so], dim=1)  # (g, 3)
    bkg = prepare(trgsw.encrypt_int(gen, sk.lv1, items, params), params, engine)
    bk_last = None
    if params.n % 2 == 1:
        bk_last = prepare(trgsw.encrypt_int(gen, sk.lv1, s0[-1:], params), params, engine)
    return bkg, bk_last


def _apply_m(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(X^a - 1) * x for a (B,) in [0, 2N): a rotation and a subtraction."""
    return poly.rotate(x, a[:, None]) - x


def grouped_step(bk_g: torch.Tensor, acc: torch.Tensor, a0: torch.Tensor, a1: torch.Tensor,
                 params: TFHEParams, engine: str = "matmul") -> torch.Tensor:
    """One group step: ``bk_g`` (3, ...) the pair's tables, ``acc`` int32
    (B, 2, N), a0 / a1 (B,) int32 in [0, 2N)."""
    digits = trgsw.decompose_trlwe(acc, params)  # shared by the three products
    c0, c1, c01 = (external_product(bk_g[t], digits, params, engine) for t in range(3))
    return acc + _apply_m(c0, a0) + _apply_m(c1, a1) + _apply_m(_apply_m(c01, a0), a1)


def blind_rotate_grouped2(ct: torch.Tensor, bkg: torch.Tensor, bk_last, testvec: torch.Tensor,
                          params: TFHEParams, engine: str = "matmul") -> torch.Tensor:
    """The grouped-2 blind rotation of lv0 TLWE ``ct`` (B, n+1), with
    ``bootstrap.blind_rotate``'s scaling: (B, 2, N) int32."""
    acc, a_steps = rotation_start(ct, testvec, params)
    for i in range(params.n // 2):
        acc = grouped_step(bkg[i], acc, a_steps[2 * i], a_steps[2 * i + 1], params, engine)
    if bk_last is not None:  # odd n: one standard CMux step for the last bit
        diff = poly.rotate(acc, a_steps[-1][:, None]) - acc
        acc = acc + external_product(bk_last[0], trgsw.decompose_trlwe(diff, params), params,
                                     engine)
    return acc


def bootstrap_grouped2(ct: torch.Tensor, bkg: torch.Tensor, bk_last, ksk: torch.Tensor,
                       params: TFHEParams, engine: str = "matmul") -> torch.Tensor:
    mu = torch.full((params.N,), params.mu, dtype=torch.int32, device=ct.device)
    rotated = blind_rotate_grouped2(ct, bkg, bk_last, trlwe.trivial(mu), params, engine)
    return identity_key_switch(trlwe.sample_extract(rotated, 0), ksk, params)


# --------------------------------------------------------------------- #
# Correctness: a NAND truth table through the grouped rotation
# --------------------------------------------------------------------- #
def check_correctness(params: TFHEParams = TEST_PARAMS, batch: int = 64, seed: int = 5,
                      engine: str = "matmul", device=None) -> tuple[int, int]:
    """(wrong, batch): NANDs of the four input pairs in turn through
    ``bootstrap_grouped2`` on ``device`` (default: the card), decrypted."""
    device = resolve_device("cuda" if device is None else device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sk = keys.gen_secret_key(gen, params, device)
    ksk = plain.prepare_ksk(keys.gen_key_switching_key_raw(gen, sk, params), params)
    bkg, bk_last = gen_grouped_bk(gen, sk, params, engine)
    pat = np.tile(np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.int32),
                  (batch // 4 + 1, 1))[:batch]
    cx, cy = (tlwe.encrypt_binary(gen, sk.lv0, torch.from_numpy(pat[:, j]).to(device), params)
              for j in range(2))
    pre = gates.precombine("nand", cx, cy, params=params)
    out = bootstrap_grouped2(pre, bkg, bk_last, ksk, params, engine)
    dec = tlwe.decrypt_binary(out, sk.lv0).cpu().numpy()
    return int((dec != 1 - (pat[:, 0] & pat[:, 1])).sum()), batch


# --------------------------------------------------------------------- #
# Timing: the standard and grouped scans over the same key bits
# --------------------------------------------------------------------- #
def scans(B: int, engine: str, device, params: TFHEParams = DEFAULT_PARAMS):
    """(acc0, run_std, run_grp) on random rows, acc and a~ (numpy seed 7):
    the grouped tables reuse the pair's two entries and the first again
    (the values do not change the time)."""
    rs = np.random.RandomState(7)
    rows = _u32.from_numpy(rs.randint(0, 2**32, size=(BITS, 2 * params.l, 2, params.N),
                                      dtype=np.uint64), device)
    bk_std = prepare(rows, params, engine)  # (BITS, ...)
    pairs = bk_std.reshape((BITS // 2, 2) + bk_std.shape[1:])
    bkg3 = torch.cat([pairs, pairs[:, :1]], dim=1)  # (BITS // 2, 3, ...)
    acc0 = _u32.from_numpy(rs.randint(0, 2**32, size=(B, 2, params.N), dtype=np.uint64), device)
    a_all = torch.from_numpy(rs.randint(0, 2 * params.N, size=(BITS, B)).astype(np.int32))
    a_all = a_all.to(device)

    def run_std(acc):
        for i in range(BITS):
            diff = poly.rotate(acc, a_all[i][:, None]) - acc
            acc = acc + external_product(bk_std[i], trgsw.decompose_trlwe(diff, params), params,
                                         engine)
        return acc

    def run_grp(acc):
        for i in range(BITS // 2):
            acc = grouped_step(bkg3[i], acc, a_all[2 * i], a_all[2 * i + 1], params, engine)
        return acc

    return acc0, run_std, run_grp


def noise_line(params: TFHEParams = DEFAULT_PARAMS) -> str:
    nb = noise_budget(params)
    grp_sigma = (nb.var_fresh + nb.var_rounding + 4.0 * nb.var_bootstrap
                 + nb.var_keyswitch) ** 0.5
    return (f"# noise: standard margin {nb.margin_sigmas:.1f} sigma; grouped-2 (x4 "
            f"blind-rotate variance) ~{(1 / 16) / grp_sigma:.1f} sigma")


def main_timing(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
                out=print, engines=ENGINES) -> dict[str, float]:
    """Seconds per key bit of each scan on each engine, at batch B on the
    card; then the noise verdict at DEFAULT_PARAMS."""
    device = _timing.require_cuda()
    p = DEFAULT_PARAMS
    _timing.header(f"grouped-2 blind rotation, bits/scan={BITS}", B, out)
    times = {}
    for engine in engines:
        acc0, run_std, run_grp = scans(B, engine, device, p)
        for name, fn in (("standard", run_std), ("grouped2", run_grp)):
            tag = f"{name} [{engine}]"
            # one step of the line is one key bit; ops: the standard count per bit
            dt = _timing.chain(Case(tag, fn, acc0, 2 * B * macs(p), steps_per_call=BITS),
                               steps, reps, out)
            out(f"#   {tag}: {dt * 1e3:.3f} ms/bit -> full n={p.n} rotation "
                f"~{dt * p.n * 1e3:.0f} ms")
            times[tag] = dt
    out(noise_line(p))
    return times


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """A grouped NAND truth table at DEFAULT_PARAMS on the card through
    K2 (raises unless every output decrypts right), then ``main_timing``."""
    device = _timing.require_cuda()
    bad, batch = check_correctness(DEFAULT_PARAMS, batch=64, seed=5, engine="cmux_k",
                                   device=device)
    out(f"# grouped-2 NAND truth table at DEFAULT_PARAMS on {_timing.card()} [cmux_k]: "
        f"{batch - bad}/{batch} correct")
    if bad:
        raise AssertionError(f"grouped-2 NAND: {bad}/{batch} wrong")
    return main_timing(B, steps, reps, out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "check":
        device = resolve_device("cpu" if "--cpu" in argv[1:] else "cuda")
        bad, batch = check_correctness(device=device)
        print(f"# grouped-2 NAND truth table on {device}: {batch - bad}/{batch} correct")
        if bad:
            raise SystemExit(f"{bad}/{batch} wrong")
        return 0
    run(int(argv[0]) if argv else DEFAULT_B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
