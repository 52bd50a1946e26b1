"""The whole rotation three ways: per-step panels, the hybrid key, P8 pairs.

Counterpart of ``benches/hybrid_unroll_probe.py``.  The odd steps' panels
are built once and kept; the even steps build theirs in the step.  Timed
over all n = 635 steps at batch B, on random rows, a~ and acc (numpy seed
11):

  production    the standard-key loop: K1 (``cmux_k.cmux_step``) per step
  hybrid key    ``keys.cloud_key_hybrid``'s key through the bootstrap's
                hybrid loop: 317 pairs of K1 and K1 on the odd step's
                prebuilt panel (``cmux_k.cmux_step_panel``), then the tail
  P8 pairs      the JAX probe's own form: the Karatsuba step (shift /
                arithmetic-shift extract) in the residue layout, the even
                step with its leaf panels built (``karatsuba_probe.
                step_var``) and the odd step on its prebuilt leaf panels
                (``unroll_probe.prebuilt_step``), then the last step

Before timing, on the card: the hybrid key's pair and the P8 pair each
equal two production steps word for word on 256 rows.  The memory: at
B=65536 the accumulator is 512 MiB and a step's digit buffers about 0.4
GB (K1) and 0.9 GB (the Karatsuba tree digits); the K1 panels of the odd
steps take 3.74 GB and their leaf panels 6.7 GB.  The allocator's peak is
printed.  Timing: the host clock around whole rotations, the card
synchronised before and after (``_timing.host_seconds``), two chained
rotations after a warm-up.

Usage: python -m rustfhe_tpu_torch.benches.hybrid_unroll_probe [B]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import _u32, bootstrap, keys
from ..engine import cmux_k, karatsuba, plain
from ..engine import karatsuba_probe as kp
from ..params import DEFAULT_PARAMS as P
from . import _timing
from .unroll_probe import prebuilt_step

DEFAULT_B = 65536
CHECK_ROWS = 256
SAR = kp.var_form(extract="sar")  # the JAX probe's extract_sar form
ROTATIONS = 2


def setup(B: int, device):
    """rows (n, 2L, 2, N), a~ (n, B), acc (B, 2, N) from numpy seed 11."""
    rs = np.random.RandomState(11)
    rows = _u32.from_numpy(rs.randint(0, 2**32, size=(P.n, 2 * P.l, 2, P.N), dtype=np.uint64),
                           device)
    a_t = torch.from_numpy(rs.randint(0, 2 * P.N, size=(P.n, B)).astype(np.int32)).to(device)
    acc0 = _u32.from_numpy(rs.randint(0, 2**32, size=(B, 2, P.N), dtype=np.uint64), device)
    return rows, a_t, acc0


def run(B: int = DEFAULT_B, out=print) -> dict[str, float]:
    """Check, then time the three rotations at batch B on the card;
    {way: seconds per step}."""
    device = _timing.require_cuda()
    torch.cuda.reset_peak_memory_stats(device)
    out(f"# whole rotation (n={P.n}) three ways on {_timing.card()}  B={B}")
    rows, a_t, acc0 = setup(B, device)
    prepared = plain.prepare_trgsw(rows)  # K1's tables (n, 2L, 2, 2N)
    hb = keys.cloud_key_hybrid(keys.CloudKey(bk=prepared, ksk=None), P).bk
    tables = torch.stack([karatsuba.prepare_table(rows[i]) for i in range(P.n)])
    npairs = P.n // 2
    leaf_odd = [kp.leaf_panel(tables[2 * i + 1], P) for i in range(npairs)]
    out(f"# prebuilt odd-step panels: K1 {hb.panels_odd.nbytes / 2**30:.2f} GiB, leaf "
        f"{sum(t.nbytes for t in leaf_odd) / 2**30:.2f} GiB")

    def production(acc):
        for i in range(P.n):
            acc = cmux_k.cmux_step(acc, a_t[i], prepared[i], P)
        return acc

    def hybrid(acc):
        return bootstrap._hybrid_rotate(acc, a_t, hb, P)

    def p8_pairs(flat):
        for i in range(npairs):
            flat = kp.step_var(flat, a_t[2 * i], tables[2 * i], P, extract="sar")
            flat = prebuilt_step(flat, a_t[2 * i + 1], leaf_odd[i], tables[2 * i + 1], P, SAR)
        for i in range(2 * npairs, P.n):
            flat = kp.step_var(flat, a_t[i], tables[i], P, extract="sar")
        return flat

    # exactness on the card: one pair of each form against two production steps
    small, a0, a1 = acc0[:CHECK_ROWS], a_t[0, :CHECK_ROWS], a_t[1, :CHECK_ROWS]
    want = cmux_k.cmux_step(cmux_k.cmux_step(small, a0, prepared[0], P), a1, prepared[1], P)
    got = cmux_k.cmux_step_panel(cmux_k.cmux_step(small, a0, hb.prep_even[0], P), a1,
                                 hb.panels_odd[0], P)
    if not torch.equal(got, want):
        raise AssertionError("the hybrid key's pair differs from two production steps")
    flat = kp.step_var(karatsuba.scan_enter(small), a0, tables[0], P, extract="sar")
    flat = prebuilt_step(flat, a1, leaf_odd[0], tables[1], P, SAR)
    if not torch.equal(karatsuba.scan_exit(flat), want):
        raise AssertionError("the P8 pair differs from two production steps")
    out(f"# exactness on the card: the hybrid key's pair and the P8 pair equal two production "
        f"steps word for word ({CHECK_ROWS} rows)")

    times = {}
    for name, fn, x0 in (("production 1-step loop", production, acc0),
                         ("hybrid key (K1 + prebuilt odd)", hybrid, acc0),
                         ("P8 pairs (prebuilt odd)", p8_pairs, karatsuba.scan_enter(acc0))):
        fn(x0)  # warm-up
        state = [x0]
        dt = _timing.host_seconds(lambda: state.append(fn(state.pop())), ROTATIONS) / P.n
        times[name] = dt
        out(f"{name:32s} {dt * 1e3:8.4f} ms/step  ({dt * P.n:7.3f} s/rotation, B={B})")
    out(f"# allocator peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    return times


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else DEFAULT_B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
