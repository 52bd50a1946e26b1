"""The bootstrap's stages one by one, each beside its bound on the card.

Counterpart of ``benches/kernels.py``: at each batch (512 and 2048 by
default) at DEFAULT_PARAMS on the production engine (``"cmux_k"``), the
time of keygen, then of

  rotation            ``poly.rotate`` of (B, 2, N): bytes read and written
  decomposition       ``trgsw.decompose_trlwe`` (B, 2, N) -> (B, 2L, N)
  external product    one (``cmux_k.external_product``, K2) on int8 digits
  blind rotation      the n = 635 K1 steps (``bootstrap.blind_rotate``)
  key switch          ``bootstrap.identity_key_switch`` (the float64 mask
                      GEMMs)

each with its share of its bound: the larger of its int8 operations over
the card's int8 peak and its bytes (each input read once, each output
written once) over the memory rate (``_timing.bound``).  The external
product's and the rotation's operations are the two-level Karatsuba
count of every CMux bound in the repo (``_timing.step_ops``); the key
switch's are the one-hot form's int8 ops (2*B*Q*(n+1)*4,
``keyswitch_probe``), not the least work: a gather-sum of B*N*iks_l KSK
rows does far less.  Timing: ``utils.timing.time_fn``, the best of 3
calls after a warm-up, each between synchronisations of the card (host
clock); keygen's one call includes the first use of every kernel.

Usage: python -m rustfhe_tpu_torch.benches.kernels [batch ...]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import _u32, bootstrap, keys, poly, trgsw, trlwe
from ..engine import cmux_k
from ..params import DEFAULT_PARAMS as P
from ..utils.timing import time_fn
from . import _timing
from .keyswitch_probe import LIMBS
from .keyswitch_probe import macs as ks_macs

BATCHES = (512, 2048)


def report(label: str, seconds: float, ops: float = 0.0, nbytes: float = 0.0,
           work: str = "", out=print) -> None:
    bound_ms, by = _timing.bound(ops, nbytes)
    out(f"{label:32s} {seconds * 1e3:10.3f} ms  bound {bound_ms:8.4f} ms by {by} "
        f"({bound_ms / 1e3 / seconds:6.1%}){'  ' + work if work else ''}")


def run(batches=BATCHES, out=print) -> dict[tuple[int, str], float]:
    """The stage table at each batch on the card; {(B, stage): seconds}."""
    device = _timing.require_cuda()
    out(f"# bootstrap stages at DEFAULT_PARAMS on {_timing.card()}")
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    sk, ck = keys.gen_keys(gen, P, device, "cmux_k")
    torch.cuda.synchronize(device)
    out(f"{'keygen (one call, first use)':32s} {(time.perf_counter() - t0) * 1e3:10.3f} ms")
    key = ck.bk[0]
    key_bytes = key.nbytes
    rs = np.random.RandomState(0)
    word = 4
    times = {}
    for B in batches:
        out(f"\n## batch = {B}")
        acc = _u32.from_numpy(rs.randint(0, 2**32, size=(B, 2, P.N), dtype=np.uint64), device)
        amounts = torch.from_numpy(rs.randint(0, 2 * P.N, size=(B, 1)).astype(np.int32))
        amounts = amounts.to(device)
        io = B * 2 * P.N * word

        t, _ = time_fn(poly.rotate, acc, amounts, device=device)
        report("rotate (B,2,N)", t, nbytes=2 * io, work=f"{2 * io / t / 1e9:.1f} GB/s", out=out)
        times[(B, "rotate")] = t

        t, digits = time_fn(trgsw.decompose_trlwe, acc, P, device=device)
        report("decompose (B,2,N)->(B,2L,N)", t, nbytes=io + B * 2 * P.l * P.N * word,
               work=f"{io / t / 1e9:.1f} GB/s in", out=out)
        times[(B, "decompose")] = t

        d8 = digits.to(torch.int8).contiguous()
        t, _ = time_fn(cmux_k.external_product, d8, key, P, device=device)
        ops = _timing.step_ops(P, B)
        gemm_ops = _timing.schoolbook_ops(P, B)
        report("external product step (K2)", t, ops=ops, nbytes=d8.nbytes + key_bytes + io,
               work=f"{gemm_ops / t / 1e12:.1f} TOPS (the schoolbook ops K2's GEMM executes)",
               out=out)
        times[(B, "external product")] = t

        cts = _u32.from_numpy(rs.randint(0, 2**32, size=(B, P.n + 1), dtype=np.uint64), device)
        testvec = trlwe.trivial(torch.full((P.N,), P.mu, dtype=torch.int32, device=device))
        t, _ = time_fn(bootstrap.blind_rotate, cts, ck.bk, testvec, P, device=device)
        step_bytes = io * 2 + key_bytes  # acc read and written, the step's key read
        report("blind rotate (n K1 steps)", t, ops=P.n * ops, nbytes=P.n * step_bytes,
               work=f"{t / P.n * 1e6:.0f} us/step; {B / t:,.0f} gates/s", out=out)
        times[(B, "blind rotate")] = t

        lv1 = _u32.from_numpy(rs.randint(0, 2**32, size=(B, P.N + 1), dtype=np.uint64), device)
        t, _ = time_fn(bootstrap.identity_key_switch, lv1, ck.ksk, P, device=device)
        q = P.N * P.iks_l * (P.iks_t - 1)
        ks_bytes = lv1.nbytes + q * (P.n + 1) * LIMBS + B * (P.n + 1) * word
        report("identity key switch", t, ops=2 * ks_macs(B, P), nbytes=ks_bytes,
               work=f"{B / t:,.0f} switches/s", out=out)
        times[(B, "key switch")] = t
    return times


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run([int(a) for a in argv] or BATCHES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
