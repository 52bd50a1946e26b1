"""Throughput benchmark: batched bootstrapped HomNAND gates/s on one card.

Counterpart of the repository's ``bench.py`` (which drives the JAX
package), with the same contract:

    python3 -m rustfhe_tpu_torch.bench

prints exactly ONE JSON line on stdout,

    {"metric": "homnand_bootstraps_per_sec_single_gpu", "value": N,
     "unit": "gates/s", "vs_baseline": N / 32.72}

and its log on stderr.  The baseline is the reference's single-core
HomNAND bootstrap at the same parameter set, 30,558,481 ns a gate ~= 32.72
gates/s (``BASELINE.md``).

Before any timing it asserts, on the device it runs on:
  * all six gates: the NAND/AND/OR/XOR truth tables, NOT, and MUX over all
    8 input combinations, as one mixed pre-combination bootstrap batch
    and the MUX second pass;
  * an encrypted 8-bit ripple-carry adder through the level-fused
    evaluator (``evaluate_encrypted(..., fixed_width=16)``), equal to
    ``evaluate_plain`` and to the sums;
  * every output of the timed NAND batch.

Environment knobs: ``BENCH_PARAMS`` = default | n2048 | pbs | fast | test,
``BENCH_BATCH`` (131072), ``BENCH_ITERS`` (3), ``BENCH_GATES`` = all | nand
(the mixed-batch and adder checks on or off).  ``BENCH_HYBRID=1``: the
hybrid key (``keys.cloud_key_hybrid``: the odd steps' panels prebuilt) for
every check and the timed pass.  ``BENCH_SHARDED=1``: after the timed
passes, the same batch through ``parallel.sharded_bootstrap_fn`` on a
(1, 1) mesh of a world of this process alone (NCCL on the card, gloo on
the CPU), asserted equal word for word to the unsharded output before it
is timed, with its gates/s as a share of the unsharded figure on stderr;
the JSON line stays the unsharded number, as in the JAX bench.  It runs
on the CUDA card, and on the CPU only when ``RUSTFHE_FORCE_CPU`` is set;
with neither, it raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_GATES_PER_SEC = 1e9 / 30_558_481.0  # 32.72
METRIC = "homnand_bootstraps_per_sec_single_gpu"
TRUTH = {
    "nand": lambda x, y: 1 - (x & y),
    "and": lambda x, y: x & y,
    "or": lambda x, y: x | y,
    "xor": lambda x, y: x ^ y,
    "not": lambda x, y: 1 - x,
}
# The adder check's operands: (a, b) pairs, 8 bits each.
ADDER_CASES = ((200, 100), (255, 255), (170, 85), (3, 4))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_device() -> torch.device:
    """The CUDA card, or the CPU when ``RUSTFHE_FORCE_CPU`` is set; a host
    with no card raises."""
    from ._device import resolve_device

    return resolve_device("cpu" if os.environ.get("RUSTFHE_FORCE_CPU") else "cuda")


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (or the
    CPU's name): every number logged stands beside it."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=True).stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device) + " (power limit not read)"


def check_mixed(ctx, batch: int) -> None:
    """The mixed correctness batch: segments of NAND/AND/OR/XOR/NOT and the
    two first-pass MUX lanes in ONE bootstrap batch of max(batch, 7 seg)
    lanes, then the MUX second pass; every output decrypted and checked."""
    from . import gates

    p = ctx.params
    seg_w = max(64, batch // 8)
    segs = []  # (op, bits_x, bits_y, pre)
    for op in ("nand", "and", "or", "xor"):
        bx = np.tile([0, 1, 0, 1], seg_w // 4 + 1)[:seg_w]
        by = np.tile([0, 0, 1, 1], seg_w // 4 + 1)[:seg_w]
        segs.append((op, bx, by, gates.precombine(op, ctx.encrypt(bx), ctx.encrypt(by), params=p)))
    bx = np.tile([0, 1], seg_w // 2)[:seg_w]
    cxn = ctx.encrypt(bx)
    segs.append(("not", bx, bx, gates.precombine("not", cxn, cxn, params=p)))
    combos = np.array([[c, a, b] for c in (0, 1) for a in (0, 1) for b in (0, 1)])
    mx = np.tile(combos, (seg_w // 8 + 1, 1))[:seg_w]
    c_ct, i0_ct, i1_ct = (ctx.encrypt(mx[:, k]) for k in range(3))
    segs.append(("mux_a", mx[:, 0], mx[:, 2], gates.precombine("and", c_ct, i1_ct, params=p)))
    segs.append(("mux_b", mx[:, 0], mx[:, 1], gates.precombine("andn", c_ct, i0_ct, params=p)))

    total = len(segs) * seg_w
    b0 = max(batch, total)
    pre = torch.cat([s[3] for s in segs])
    if total < b0:  # pad with extra NAND rows so the shape is the metric's
        pre = torch.cat([pre, segs[0][3].repeat((b0 - total) // seg_w + 1, 1)[: b0 - total]])
    t0 = time.perf_counter()
    out = ctx.bootstrap_raw(pre)
    _sync(ctx.device)
    log(f"# first mixed-gate batch ({b0} lanes): {time.perf_counter() - t0:.2f}s")
    dec = ctx.decrypt(out).cpu().numpy()
    outs = {}
    for i, (op, bx, by, _) in enumerate(segs):
        outs[op] = out[i * seg_w: (i + 1) * seg_w]
        if op in TRUTH:
            bad = int((dec[i * seg_w: (i + 1) * seg_w] != TRUTH[op](bx, by)).sum())
            assert bad == 0, f"{op}: {bad}/{seg_w} wrong outputs on {ctx.device}"
            log(f"# correctness[{op}]: {seg_w}/{seg_w} outputs decode correctly")
    # MUX second pass: or(mux_a, mux_b), padded to the same batch shape.
    pre_or = gates.precombine("or", outs["mux_a"], outs["mux_b"], params=p)
    out2 = ctx.bootstrap_raw(pre_or.repeat(b0 // seg_w + 1, 1)[:b0])
    dec2 = ctx.decrypt(out2[:seg_w]).cpu().numpy()
    bad = int((dec2 != np.where(mx[:, 0] == 1, mx[:, 2], mx[:, 1])).sum())
    assert bad == 0, f"mux: {bad}/{seg_w} wrong outputs on {ctx.device}"
    log(f"# correctness[mux]: {seg_w}/{seg_w} outputs decode correctly (all 8 combos)")


def check_adder(ctx) -> float:
    """The encrypted 8-bit ripple-carry adder through the level-fused
    evaluator at fixed width 16, against ``evaluate_plain`` and the sums.
    Returns its seconds."""
    from .apps.circuits import evaluate_encrypted, evaluate_plain, ripple_carry_adder

    adder = ripple_carry_adder(8)
    cases = np.array(ADDER_CASES, np.int64)
    bits = np.zeros((len(cases), 16), np.int64)
    for i in range(8):
        bits[:, i] = (cases[:, 0] >> i) & 1
        bits[:, 8 + i] = (cases[:, 1] >> i) & 1
    cts = ctx.encrypt(bits)
    t0 = time.perf_counter()
    dec = ctx.decrypt(evaluate_encrypted(adder, ctx, cts, fixed_width=16)).cpu().numpy()
    seconds = time.perf_counter() - t0
    assert np.array_equal(dec, evaluate_plain(adder, bits)), "adder: encrypted != plain evaluation"
    sums = [sum(int(dec[r, i]) << i for i in range(9)) for r in range(len(cases))]
    assert sums == [int(a) + int(b) for a, b in cases], sums
    log(f"# correctness[adder8]: {len(cases)} sums correct ({seconds:.2f}s, level-fused, "
        "width 16)")
    return seconds


def bench_sharded(ctx, pre, want, gps: float, iters: int, card: str) -> None:
    """The timed batch through ``sharded_bootstrap_fn`` on a (1, 1) mesh of
    a world of this process alone: equal word for word to the unsharded
    output ``want``, then timed; its gates/s beside the unsharded ``gps``."""
    from .parallel import make_mesh, multihost, shard_cloud_key, sharded_bootstrap_fn

    multihost.initialize(device=ctx.device)
    try:
        mesh = make_mesh()
        ck = shard_cloud_key(ctx.ck, mesh)
        fn = sharded_bootstrap_fn(mesh, ctx.params, ctx.engine_name)
        t0 = time.perf_counter()
        out = fn(ck.bk, ck.ksk, pre)
        _sync(ctx.device)
        log(f"# first sharded run: {time.perf_counter() - t0:.2f}s (mesh data=1, model=1, "
            f"engine {ctx.engine_name})")
        assert torch.equal(out, want), "sharded output differs from unsharded"
        log(f"# correctness[sharded]: equal word for word to the unsharded output "
            f"({pre.shape[0]} gates)")
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(ck.bk, ck.ksk, pre)
            _sync(ctx.device)
            times.append(time.perf_counter() - t0)
        sgps = pre.shape[0] / min(times)
        log(f"# sharded per-batch: {min(times) * 1e3:.1f} ms -> {sgps:,.1f} gates/s "
            f"({sgps / gps * 100:.1f}% of unsharded) on {card}")
    finally:
        multihost.shutdown()


def main() -> None:
    from . import gates
    from .context import TFHE
    from .params import DEFAULT_PARAMS, FAST_PARAMS, N2048_PARAMS, PBS_PARAMS, TEST_PARAMS

    p = {
        "default": DEFAULT_PARAMS,
        "n2048": N2048_PARAMS,
        "pbs": PBS_PARAMS,
        "fast": FAST_PARAMS,
        "test": TEST_PARAMS,  # CPU smoke runs of the bench logic itself
    }[os.environ.get("BENCH_PARAMS", "default")]
    batch = int(os.environ.get("BENCH_BATCH", "131072"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    check_all = os.environ.get("BENCH_GATES", "all") == "all"

    device = bench_device()
    card = card_name(device)
    log(f"# device: {device} {card}")
    t0 = time.perf_counter()
    ctx = TFHE.new(0, p, device=device)
    _sync(device)
    log(f"# engine: {ctx.engine_name}; keygen {time.perf_counter() - t0:.2f}s")
    if os.environ.get("BENCH_HYBRID", "0") == "1":
        # Hybrid keys: the odd steps' panels prebuilt; every check below
        # and the timed pass then run the hybrid rotation.
        from .keys import cloud_key_hybrid

        t0 = time.perf_counter()
        ck = cloud_key_hybrid(ctx.ck, p, ctx.engine_name)
        _sync(device)
        log(f"# hybrid key (odd-step panels prebuilt): {time.perf_counter() - t0:.2f}s"
            if ck is not ctx.ck else f"# engine {ctx.engine_name} has no hybrid form: "
            "the standard key")
        ctx.ck = ck

    if check_all:
        check_mixed(ctx, batch)
        check_adder(ctx)

    # The timed NAND batch; its linear pre-combination is computed once.
    pat = np.tile(np.array([[0, 0], [1, 0], [0, 1], [1, 1]]), (batch // 4 + 1, 1))[:batch]
    pre_nand = gates.precombine("nand", ctx.encrypt(pat[:, 0]), ctx.encrypt(pat[:, 1]), params=p)

    def run():
        out = gates.hom_bootstrap(ctx.ck, pre_nand, params=p)
        _sync(device)
        return out

    t0 = time.perf_counter()
    out = run()
    log(f"# first timed run: {time.perf_counter() - t0:.2f}s")
    n_bad = int((ctx.decrypt(out).cpu().numpy() != 1 - (pat[:, 0] & pat[:, 1])).sum())
    assert n_bad == 0, f"correctness failure: {n_bad}/{batch} wrong NAND outputs"
    log(f"# correctness[nand-timed]: {batch}/{batch} NAND outputs decode correctly")
    del out

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    gps = batch / best
    log(f"# per-batch: {best * 1e3:.1f} ms ({batch} gates) -> {gps:,.1f} gates/s on {card} "
        f"(runs: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms)")
    if os.environ.get("BENCH_SHARDED", "0") == "1":
        bench_sharded(ctx, pre_nand, run(), gps, iters, card)
    print(json.dumps({"metric": METRIC, "value": round(gps, 1), "unit": "gates/s",
                      "vs_baseline": round(gps / BASELINE_GATES_PER_SEC, 1)}))


if __name__ == "__main__":
    main()
