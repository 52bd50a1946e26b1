"""The single-gate latency of the console's path, per key mode.

Counterpart of ``benches/repl_latency_probe.py``; the reference evaluates
one HomNAND in 30.6 ms on its CPU (``BASELINE.md``), and every line prints
its number beside that one.

  1. the dispatch floor: one tiny torch op on the card and a synchronise;
  2. per key mode, built, measured and released one at a time: standard
     (the K1 loop), latency (``keys.cloud_key_latency``: K3), hybrid
     (``keys.cloud_key_hybrid``: the odd steps on prebuilt panels) and
     hybrid with full panels (no panel kernel in the rotation): the B=1
     bootstrap, a chain whose output is the next call's input, and the
     fused single NAND of the console (``apps.replprog.FusedEvaluator``,
     the plan lowered on the host, one bootstrap, the lv1 decryption);
  3. the fused three-gate expression on the last mode.

``PROBE_MODES`` (comma-separated: standard, panels, hybrid, hybrid_full)
picks the modes, as in the JAX script; ``PROBE_ITERS`` the calls per
number (10).  Every fused expression must decrypt to its value, and a
failure raises.  Timing: the host clock, the card synchronised before and
after ITERS calls in a row (``_timing.host_seconds``); the fused calls
read their bit back to the host, which synchronises each.

Usage: python -m rustfhe_tpu_torch.benches.repl_latency_probe
"""

from __future__ import annotations

import os
import sys

import torch

from .. import gates, keys, tlwe
from ..apps import nander
from ..apps.replprog import FusedEvaluator
from ..context import TFHE
from ..engine import select_fast_engine
from ..params import DEFAULT_PARAMS as P
from . import _timing

REFERENCE_MS = 30.6  # the reference's single HomNAND on one CPU core (BASELINE.md)
MODES = ("standard", "panels", "hybrid", "hybrid_full")
NAMES = {"standard": "standard", "panels": "latency (K3)", "hybrid": "hybrid",
         "hybrid_full": "hybrid full-panels"}


def iters() -> int:
    return int(os.environ.get("PROBE_ITERS", "10"))


def modes() -> list[str]:
    sel = os.environ.get("PROBE_MODES", ",".join(MODES)).split(",")
    return [m for m in MODES if m in sel]


def build_key(mode: str, ck: keys.CloudKey, eng: str) -> keys.CloudKey:
    if mode == "standard":
        return ck
    if mode == "panels":
        return keys.cloud_key_latency(ck)
    return keys.cloud_key_hybrid(ck, P, eng, full_panels=mode == "hybrid_full")


def line(tag: str, seconds: float, what: str) -> str:
    ms = seconds * 1e3
    return (f"{tag}: {ms:.2f} ms ({ms / REFERENCE_MS:.2f}x the reference's {REFERENCE_MS} ms; "
            f"{what})")


def fused(ctx: TFHE, expr: str, want: int, n: int) -> float:
    """Seconds per ``FusedEvaluator.eval_bit`` of ``expr``, after one call
    that checks it; every call must give ``want``."""
    ev = FusedEvaluator(ctx)
    ast = nander.parse_logic_expr(expr)

    def one():
        got = ev.eval_bit(ast)
        if got != want:
            raise AssertionError(f"fused {expr!r} gave {got}, expected {want}")

    one()
    return _timing.host_seconds(one, n)


def run(out=print) -> dict[str, float]:
    """Every number on the card, ``PROBE_ITERS`` calls each; {line: seconds}."""
    device = _timing.require_cuda()
    n = iters()
    out(f"# single-gate latency on {_timing.card()}  iters={n}")
    eng = select_fast_engine(P, device)
    gen = torch.Generator(device=device).manual_seed(0)
    sk, ck = keys.gen_keys(gen, P, device, eng)
    c1 = tlwe.encrypt_binary(gen, sk.lv0, torch.ones(1, dtype=torch.int32, device=device), P)
    times = {}
    one = torch.ones((), dtype=torch.int32, device=device)

    def floor():
        c1.add(one)
        torch.cuda.synchronize(device)

    times["dispatch floor"] = _timing.host_seconds(floor, n)
    out(line("dispatch floor (one tiny op + synchronize)", times["dispatch floor"],
             "host clock"))
    selected = modes()
    last_ctx = None
    for mode in selected:
        tag = NAMES[mode]
        torch.cuda.reset_peak_memory_stats(device)
        built = []
        build_s = _timing.host_seconds(lambda: built.append(build_key(mode, ck, eng)))
        ckm = built.pop()
        out(f"# [{tag}] key ready in {build_s:.2f} s, allocator peak "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")

        def boot(x, ckm=ckm):
            return gates.hom_bootstrap(ckm, gates.precombine("nand", x, x, params=P), params=P,
                                       engine_name=eng)

        state = [boot(c1)]
        before = _timing.rotation_launches()
        dt = _timing.host_seconds(lambda: state.append(boot(state.pop())), n)
        times[f"B=1 bootstrap [{tag}]"] = dt
        out(line(f"B=1 bootstrap [{tag}]", dt, f"chained, {_timing.ran(before)} in {n} calls"))
        ctx = TFHE(sk, ckm, P, device, engine_name=eng)
        before = _timing.rotation_launches()
        dt = fused(ctx, "1 $ 0", 1, n)
        times[f"fused REPL NAND [{tag}]"] = dt
        out(line(f"fused REPL NAND [{tag}]", dt, f"{_timing.ran(before)} in {n + 1} calls"))
        last_ctx = ctx if mode == selected[-1] else None
        del ckm, ctx, state
        torch.cuda.empty_cache()
    if last_ctx is not None:
        tag = NAMES[selected[-1]]
        before = _timing.rotation_launches()
        dt = fused(last_ctx, "(1 & 0) ^ !0", 1, n)
        times[f"fused 3-gate expr [{tag}]"] = dt
        out(line(f"fused 3-gate expr [{tag}]", dt, f"{_timing.ran(before)} in {n + 1} calls"))
    return times


def main(argv=None) -> int:
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
