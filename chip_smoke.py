#!/usr/bin/env python3
"""Drive the port's batched gate bootstrap and its interactive console once
on a CUDA card.

Run from the repository root, on a host with one NVIDIA H100:

    python3 chip_smoke.py

It takes no arguments.  It imports ``rustfhe_tpu_torch`` and nothing of
JAX, and runs at DEFAULT_PARAMS (n=635, N=1024, l=3, Bg=2^6, key switch
2x8), the reference's ~128-bit parameter set, with keys and inputs made
from seed 0.  Phases, one line each:

  1. environment: torch, CUDA, nvcc, the card;
  2. build: the CUDA kernels from ``rustfhe_tpu_torch/csrc`` (nvcc, first use);
  3. kernels: K1 (CMux step) and K2 (external product) on the card against
     their plain torch versions, bit for bit, and K2 against the oracle, on
     edge inputs and at the main path's batches (1024 and 4096); each
     kernel's time beside its plain version's;
  4. main path: ``TFHE.new`` (keygen on the card, K2 probe), one mixed
     bootstrap batch with the NAND/AND/OR/XOR truth tables, NOT and both
     MUX first-pass lanes over all 8 combinations, then the MUX second
     pass; every output decrypted and checked;
  5. timed NAND batch of 4096 gates: decrypt-checked, gates/s, then one
     pass layer by layer under ``torch.profiler`` (each kernel's share of
     device time, the device's idle share, peak device memory, and the SM
     clock sampled by nvidia-smi during the pass);
  6. K1 on the real bootstrapping key: the first steps of both main-path
     batches' blind rotations, kernel against plain version, bit for bit;
  7. latency path: K3 (the single-launch blind rotation) against its plain
     version and the K1 loop over all n steps, bit for bit, on random keys
     at B = 1, 8, 32, 33; K3's time per rotation beside the K1 loop's and
     the plain version's; then the nander console in latency mode
     (``nander_console(..., latency_mode=True)``) on a fixed script, every
     ``res:`` checked against ``PlainLogic``, with exactly one K3 launch
     per blind rotation and no K1 launch; then K3 on the real latency key
     from the real first accumulators, and the console's single-NAND
     program layer by layer under ``torch.profiler``.

Then one JSON line of kernels, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import io
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from rustfhe_tpu_torch import TFHE, _u32, bootstrap, gates, tlwe, trlwe
from rustfhe_tpu_torch.apps import nander
from rustfhe_tpu_torch.apps.replprog import FusedEvaluator
from rustfhe_tpu_torch.engine import build, cmux_k, oracle, plain, probe_vectors, rotate_all_k
from rustfhe_tpu_torch.params import DEFAULT_PARAMS

KERNEL_SOURCE = "rustfhe_tpu_torch/csrc/cmux_k.cu"
K3_SOURCE = "rustfhe_tpu_torch/csrc/rotate_all_k.cu"
SEED = 0
MIXED = 1024  # the mixed truth-table batch
BATCH = 4096  # the timed NAND batch
IMAD_PER_CLK_SM = 64  # 32-bit integer multiply-add issue rate of sm_90 (published)
TRUTH = {
    "nand": lambda x, y: 1 - (x & y),
    "and": lambda x, y: x & y,
    "or": lambda x, y: x | y,
    "xor": lambda x, y: x ^ y,
    "not": lambda x, y: 1 - x,
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def exact(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    err = max_abs_err(got.cpu(), want.cpu())
    if got.shape != want.shape or err != 0:
        raise AssertionError(f"{name}: kernel differs from its reference (max |err| {err})")
    return err


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ab_ms(kernel, plain_fn, iters: int) -> tuple[float, float]:
    """Times in turns (plain, kernel, kernel, plain); the mean of each pair."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def words(rs, shape, dev):
    return _u32.from_numpy(rs.randint(0, 2**32, size=shape, dtype=np.uint64), dev)


def phase_kernels(p, dev, rs):
    """K1 and K2 against their plain versions (and K2 against the oracle) at
    DEFAULT_PARAMS, on edge inputs and at the main path's batches, then
    their times at the main path's shapes."""
    two_l, N = 2 * p.l, p.N
    key = plain.prepare_trgsw(words(rs, (two_l, 2, N), dev))
    errs = {"k1": 0, "k2": 0}

    # K1 on random accumulators and rotations, B=256.
    acc = words(rs, (256, 2, N), dev)
    ai = torch.from_numpy(rs.randint(0, 2 * N, size=256).astype(np.int32)).to(dev)
    errs["k1"] = max(errs["k1"], exact("K1 random", cmux_k.cmux_step(acc, ai, key, p),
                                       cmux_k.cmux_step_plain(acc, ai, key, p)))
    # K1 on accumulators made from the probe vectors' rows, at edge rotations.
    rows_np, digits_np = probe_vectors(p)
    prows = _u32.from_numpy(rows_np, dev)
    pkey = plain.prepare_trgsw(prows)
    pai = torch.tensor([0, 1, N - 1, N, N + 1, 2 * N - 1], dtype=torch.int32, device=dev)
    errs["k1"] = max(errs["k1"], exact("K1 probe", cmux_k.cmux_step(prows, pai, pkey, p),
                                       cmux_k.cmux_step_plain(prows, pai, pkey, p)))
    # K2 on the probe vectors: against the plain version and the oracle.
    pd = torch.from_numpy(digits_np).to(torch.int8).to(dev)
    got = cmux_k.external_product(pd, pkey, p)
    errs["k2"] = max(errs["k2"], exact("K2 probe", got, cmux_k.external_product_plain(pd, pkey)))
    want = oracle.external_product(_u32.from_numpy(rows_np), torch.from_numpy(digits_np))
    errs["k2"] = max(errs["k2"], exact("K2 probe vs oracle", got, want))
    # K2 on random digits, B=256.
    hb = p.half_bg
    rd = torch.from_numpy(rs.randint(-hb, hb, size=(256, two_l, N)).astype(np.int8)).to(dev)
    errs["k2"] = max(errs["k2"], exact("K2 random", cmux_k.external_product(rd, key, p),
                                       cmux_k.external_product_plain(rd, key)))
    # K1 and K2 at the main path's batches: the mixed batch and the NAND batch.
    for b in (MIXED, BATCH):
        accb = words(rs, (b, 2, N), dev)
        aib = torch.from_numpy(rs.randint(0, 2 * N, size=b).astype(np.int32)).to(dev)
        errs["k1"] = max(errs["k1"], exact(f"K1 B={b}", cmux_k.cmux_step(accb, aib, key, p),
                                           cmux_k.cmux_step_plain(accb, aib, key, p)))
        db = torch.from_numpy(rs.randint(-hb, hb, size=(b, two_l, N)).astype(np.int8)).to(dev)
        errs["k2"] = max(errs["k2"], exact(f"K2 B={b}", cmux_k.external_product(db, key, p),
                                           cmux_k.external_product_plain(db, key)))
    torch.cuda.synchronize()
    log("kernels", f"K1 and K2 bit-exact against their plain versions on {dev} "
        f"(edge inputs, B=256, B={MIXED}, B={BATCH}); K2 equals the oracle on the probe vectors")

    # Times at the main path's shapes: K1 at the timed batch, K2 at the probe.
    k1_ms, k1_plain = ab_ms(lambda: cmux_k.cmux_step(accb, aib, key, p),
                            lambda: cmux_k.cmux_step_plain(accb, aib, key, p), 10)
    k2_ms, k2_plain = ab_ms(lambda: cmux_k.external_product(pd, pkey, p),
                            lambda: cmux_k.external_product_plain(pd, pkey), 20)
    k2b_ms, k2b_plain = ab_ms(lambda: cmux_k.external_product(db, key, p),
                              lambda: cmux_k.external_product_plain(db, key), 10)
    log("kernels", f"K1 cmux_step B={BATCH}: {k1_ms:.4f} ms, plain {k1_plain:.4f} ms | "
        f"K2 external_product B={pd.shape[0]} (probe): {k2_ms:.4f} ms, plain {k2_plain:.4f} ms | "
        f"K2 B={BATCH}: {k2b_ms:.4f} ms, plain {k2b_plain:.4f} ms")
    return errs, {"k1": (k1_ms, k1_plain), "k2": (k2_ms, k2_plain)}


def check_bits(name: str, got: np.ndarray, want: np.ndarray) -> None:
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"{name}: {bad}/{len(want)} outputs decrypt wrong")


def one_pass(fn, p):
    """Run one bootstrap pass and check that it launched K1 once per step."""
    before = cmux_k.cmux_step.launches
    out = fn()
    torch.cuda.synchronize()
    launched = cmux_k.cmux_step.launches - before
    if launched != p.n:
        raise AssertionError(f"a bootstrap pass launched K1 {launched} times, expected {p.n}")
    return out


def phase_main_path(p, dev):
    """Keygen on the card, then bench.py's mixed truth-table batch and the
    MUX second pass, every output decrypted and checked."""
    t0 = time.perf_counter()
    ctx = TFHE.new(SEED, p, device=dev)
    torch.cuda.synchronize()
    log("main", f"TFHE.new on {dev}: engine {ctx.engine_name} admitted by the K2 oracle "
        f"probe, keys generated in {time.perf_counter() - t0:.2f} s")

    seg = MIXED // 8
    segs = []  # (op, x bits, y bits, pre)
    for op in ("nand", "and", "or", "xor"):
        bx = np.tile([0, 1, 0, 1], seg // 4 + 1)[:seg]
        by = np.tile([0, 0, 1, 1], seg // 4 + 1)[:seg]
        segs.append((op, bx, by, gates.precombine(op, ctx.encrypt(bx), ctx.encrypt(by),
                                                  params=p)))
    bx = np.tile([0, 1], seg // 2 + 1)[:seg]
    cx = ctx.encrypt(bx)
    segs.append(("not", bx, bx, gates.precombine("not", cx, params=p)))
    combos = np.array([[c, a, b] for c in (0, 1) for a in (0, 1) for b in (0, 1)])
    mx = np.tile(combos, (seg // 8 + 1, 1))[:seg]
    c_ct, i0_ct, i1_ct = (ctx.encrypt(mx[:, k]) for k in range(3))
    segs.append(("mux_a", mx[:, 0], mx[:, 2], gates.precombine("and", c_ct, i1_ct, params=p)))
    segs.append(("mux_b", mx[:, 0], mx[:, 1], gates.precombine("andn", c_ct, i0_ct, params=p)))
    pre = torch.cat([s[3] for s in segs])
    pad = MIXED - pre.shape[0]
    pre = torch.cat([pre, segs[0][3].repeat(pad // seg + 1, 1)[:pad]])

    t0 = time.perf_counter()
    out = one_pass(lambda: ctx.bootstrap_raw(pre), p)
    t_mixed = time.perf_counter() - t0
    dec = ctx.decrypt(out).cpu().numpy()
    outs = {}
    for i, (op, x, y, _) in enumerate(segs):
        outs[op] = out[i * seg: (i + 1) * seg]
        if op in TRUTH:
            check_bits(op, dec[i * seg: (i + 1) * seg], TRUTH[op](x, y))
    pre_or = gates.precombine("or", outs["mux_a"], outs["mux_b"], params=p)
    out2 = one_pass(lambda: ctx.bootstrap_raw(pre_or.repeat(MIXED // seg, 1)), p)
    check_bits("mux", ctx.decrypt(out2[:seg]).cpu().numpy(),
               np.where(mx[:, 0] == 1, mx[:, 2], mx[:, 1]))
    log("main", f"mixed batch of {MIXED} gates ({seg} each of NAND, AND, OR, XOR, NOT and "
        f"both MUX lanes) in {t_mixed:.3f} s, then the MUX second pass: every output "
        "decrypts correctly (NAND/AND/OR/XOR truth tables, NOT, MUX over all 8 combinations)")
    return ctx, pre


def sample_sm_clock():
    """Start nvidia-smi sampling the card's SM clock (MHz) every 100 ms."""
    return subprocess.Popen(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def stop_sampling(proc) -> list[float]:
    proc.terminate()
    try:
        out, _ = proc.communicate(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]


def device_times(prof) -> dict[str, float]:
    """Self device time (ms) of each kernel the profiler saw on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    times = {}
    for e in prof.key_averages():
        if e.device_type == cuda:
            times[e.key] = times.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return times


def phase_nand(ctx, p, card):
    """Timed NAND batch, decrypt-checked, then one pass layer by layer under
    the profiler.  Returns the NAND batch's inputs and the passes run."""
    pat = np.tile(np.array([[0, 0], [1, 0], [0, 1], [1, 1]]), (BATCH // 4 + 1, 1))[:BATCH]
    cx, cy = ctx.encrypt(pat[:, 0]), ctx.encrypt(pat[:, 1])
    out = one_pass(lambda: ctx.nand(cx, cy), p)
    check_bits("nand", ctx.decrypt(out).cpu().numpy(), 1 - (pat[:, 0] & pat[:, 1]))
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        one_pass(lambda: ctx.nand(cx, cy), p)
        times.append(time.perf_counter() - t0)
    best = min(times)
    log("nand", f"B={BATCH}: {BATCH}/{BATCH} NAND outputs decrypt correctly; "
        f"{best * 1e3:.1f} ms per batch -> {BATCH / best:.1f} gates/s "
        f"(best of {len(times)}: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms) on {card}")

    # One more pass, layer by layer (host clock around synchronised work),
    # under torch.profiler, with the SM clock sampled alongside.
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    testvec = trlwe.trivial(torch.full((p.N,), p.mu, dtype=torch.int32, device=cx.device))
    torch.cuda.reset_peak_memory_stats(cx.device)
    before = cmux_k.cmux_step.launches
    clock = sample_sm_clock()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            pre, t_pre = timed(lambda: gates.precombine("nand", cx, cy, params=p))
            acc, t_rot = timed(lambda: bootstrap.blind_rotate(pre, ctx.ck.bk, testvec, p))
            lv1, t_ext = timed(lambda: trlwe.sample_extract(acc, 0))
            lv0, t_ks = timed(lambda: bootstrap.identity_key_switch(lv1, ctx.ck.ksk, p))
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        mhz = stop_sampling(clock)
    peak = torch.cuda.max_memory_allocated(cx.device)
    if cmux_k.cmux_step.launches - before != p.n:
        raise AssertionError("the layered pass did not launch K1 once per step")
    if not torch.equal(lv0, out):
        raise AssertionError("the layered pass differs from ctx.nand")
    log("breakdown", f"B={BATCH} on {card}, profiled: precombine {t_pre:.2f} ms, blind "
        f"rotate {t_rot:.1f} ms ({p.n} K1 launches, {t_rot / p.n:.3f} ms/step), sample "
        f"extract {t_ext:.2f} ms, key switch {t_ks:.2f} ms; pass {wall:.1f} ms")

    dev_ms = device_times(prof)
    busy = sum(dev_ms.values())
    clock_txt = (f"SM clock {min(mhz):.0f}-{max(mhz):.0f} MHz, mean {np.mean(mhz):.0f} "
                 f"({len(mhz)} nvidia-smi samples)" if mhz else "SM clock not measured")
    if busy > 0:
        top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:3]
        k1 = sum(v for k, v in dev_ms.items() if "cmux_step_kernel" in k)
        log("profile", f"B={BATCH} on {card}: device busy {busy:.1f} ms of {wall:.1f} ms "
            f"wall, idle share {1 - busy / wall:.4f}; cmux_step_kernel {k1:.1f} ms "
            f"({k1 / busy:.2%} of device time); top kernels: "
            + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top)
            + f"; peak device memory {peak / 2**30:.3f} GiB; {clock_txt}")
    else:
        log("profile", f"B={BATCH} on {card}: the profiler saw no device time (device "
            f"breakdown not measured); peak device memory {peak / 2**30:.3f} GiB; {clock_txt}")
    if mhz:
        sms = torch.cuda.get_device_properties(cx.device).multi_processor_count
        rate = BATCH * 2 * p.N * 2 * p.l * p.N / (t_rot / p.n * 1e-3)
        peak_rate = IMAD_PER_CLK_SM * sms * np.mean(mhz) * 1e6
        log("profile", f"K1 issues {rate / 1e12:.2f} T IMAD/s; estimate against "
            f"{IMAD_PER_CLK_SM} IMAD/clk/SM (published) x {sms} SMs x the mean sampled "
            f"clock: {rate / peak_rate:.1%} of that peak")
    return cx, cy, 4  # bootstrap passes run here


def phase_real_key(ctx, p, batches):
    """K1 on the prepared bootstrapping key against its plain version: the
    first steps of each batch's blind rotation from its real first
    accumulator, then the last step's key slice."""
    testvec = trlwe.trivial(torch.full((p.N,), p.mu, dtype=torch.int32, device=ctx.device))
    err = 0
    for pre in batches:
        acc, a_steps = bootstrap.rotation_start(pre, testvec, p)
        for i in (0, 1, 2, p.n - 1):
            got = cmux_k.cmux_step(acc, a_steps[i], ctx.ck.bk[i], p)
            err = max(err, exact(f"K1 on bk[{i}], B={pre.shape[0]}", got,
                                 cmux_k.cmux_step_plain(acc, a_steps[i], ctx.ck.bk[i], p)))
            acc = got
    log("realkey", "K1 bit-exact against its plain version on the bootstrapping key "
        f"(steps 0, 1, 2 and {p.n - 1}) from the real accumulators, "
        f"B={', '.join(str(b.shape[0]) for b in batches)}")
    return err


# --------------------------------------------------------------------- #
# 7. The latency path: K3 and the nander console in latency mode
# --------------------------------------------------------------------- #
LATENCY_CHECK = (1, 8, 32, 33)            # K3 against plain and K1 loop, bit for bit
LATENCY_TIMES = (1, 8, 32, 128, 256, 512)  # K3 and K1 loop per rotation
PLAIN_TIMES = (1, 8, 32, 128)             # and the plain version
# The console script: the 13 expressions of the JAX package's REPL tests,
# one pipelined line of 32 single gates, and one parse error.
EXPRS = [
    "1", "0", "!1", "!!0",
    "1 $ 0", "0 $ 0", "1 & 1", "1 | 0", "1 ^ 1",
    "(1 & 0) ^ !0",
    "1 & 1 & 0 | 1",
    "((1|0)&(1^1))$(0|1)",
    "!(1 & (0 | !1)) ^ (1 $ (0 ^ 1))",
]
PIPELINED = [f"{neg}{a} {op} {b}" for op in "$&|^" for a in "01" for b in "01"
             for neg in ("", "!")]
PARSE_ERROR = "1 & 2"
SINGLE_NAND = ("1 $ 0", "0 $ 0")


def rotation_case(rs, p, b, dev):
    acc = words(rs, (b, 2, p.N), dev)
    a = torch.from_numpy(rs.randint(0, 2 * p.N, size=(p.n, b)).astype(np.int32)).to(dev)
    return acc, a


def k1_loop(acc, a_steps, bk, p):
    for i in range(p.n):
        acc = cmux_k.cmux_step(acc, a_steps[i], bk[i], p)
    return acc


def phase_latency_kernels(p, dev, rs, card):
    """K3 against its plain version and the K1 loop over all n steps, on a
    random key; then the three times per rotation."""
    bk = plain.prepare_trgsw(words(rs, (p.n, 2 * p.l, 2, p.N), dev))
    err = 0
    for b in LATENCY_CHECK:
        acc, a = rotation_case(rs, p, b, dev)
        got = rotate_all_k.rotate_all(acc, a, bk, p)
        err = max(err, exact(f"K3 B={b} vs plain", got, rotate_all_k.rotate_all_plain(acc, a, bk, p)),
                  exact(f"K3 B={b} vs K1 loop", got, k1_loop(acc, a, bk, p)))
    torch.cuda.synchronize()
    log("latency", f"K3 bit-exact against its plain version and the K1 loop over all {p.n} "
        f"steps, random key, B={', '.join(map(str, LATENCY_CHECK))}; the card holds "
        f"{rotate_all_k.max_clusters(p)} K3 clusters at once")

    times = {}
    for b in LATENCY_TIMES:
        acc, a = rotation_case(rs, p, b, dev)
        k3, k1 = ab_ms(lambda: rotate_all_k.rotate_all(acc, a, bk, p),
                       lambda: k1_loop(acc, a, bk, p), 2)
        pl = cuda_ms(lambda: rotate_all_k.rotate_all_plain(acc, a, bk, p), 1) \
            if b in PLAIN_TIMES else None
        times[b] = (k3, k1, pl)
        log("latency", f"B={b} on {card}: K3 {k3:.3f} ms per rotation, K1 loop {k1:.3f} ms, "
            + (f"plain {pl:.3f} ms" if pl is not None else "plain not timed at this batch"))
    return err, times


def expected_rotations(script):
    """Blind rotations the console runs for the script: one per level of
    each fused plan (width 32, 128 wires: the console's capacities on the
    card), none for a constant."""
    fused = FusedEvaluator(None, width=32, max_wires=128)  # planning only
    total = 0
    for line in script:
        if ";" in line:
            asts = [nander.parse_logic_expr(e) for e in line.split(";")]
            plan = fused._plan_many(asts)
            if plan is None:
                raise AssertionError("the pipelined line does not fit the fused evaluator")
            total += 0 if plan[0] == "const" else len(plan[2])
            continue
        try:
            plan = fused._plan(nander.parse_logic_expr(line))
        except nander.ParseError:
            continue
        if plan is None:
            raise AssertionError(f"{line!r} does not fit the fused evaluator")
        total += 0 if plan[0] == "const" else len(plan[3]) + 1
    return total


def phase_console(p, dev, card):
    """The nander console in latency mode on the fixed script: every res:
    line against PlainLogic, one K3 launch per blind rotation, no K1."""
    plain_logic = nander.PlainLogic()
    script = EXPRS + ["; ".join(PIPELINED), PARSE_ERROR]
    want_rot = expected_rotations(script)
    out = io.StringIO()
    cmux_k.reset_counters()
    rotate_all_k.rotate_all.launches = 0
    t0 = time.perf_counter()
    nander.nander_console(p, dev, io.StringIO("\n".join(script) + "\n"), out,
                          latency_mode=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k3": rotate_all_k.rotate_all.launches, "k1": cmux_k.cmux_step.launches,
                "k2": cmux_k.external_product.launches}
    if launches["k3"] != want_rot or launches["k1"] != 0:
        raise AssertionError(f"console launches {launches}, expected K3 = {want_rot} "
                             "(one per blind rotation) and no K1")

    lines = out.getvalue().splitlines()
    res = [ln for ln in lines if ln.startswith("res: ")]
    tms = [ln for ln in lines if ln.startswith("time: ")]
    if len(res) != len(EXPRS) + 1 or len(tms) != len(res):
        raise AssertionError("console output:\n" + out.getvalue())
    for e, ln in zip(EXPRS, res):
        want = nander.eval_logic_expr(plain_logic, nander.parse_logic_expr(e))
        if ln != f"res: {want}":
            raise AssertionError(f"console: {e!r} gave {ln!r}, want res: {want}")
    want = " ".join(str(nander.eval_logic_expr(plain_logic, nander.parse_logic_expr(e)))
                    for e in PIPELINED)
    if res[-1] != f"res: {want}":
        raise AssertionError(f"console: pipelined line gave {res[-1]!r}, want res: {want}")
    if not any(ln.startswith("parse error: ") for ln in lines):
        raise AssertionError("console: no parse error for " + repr(PARSE_ERROR))

    us = [float(re.match(r"time: (\d+) us", t).group(1)) for t in tms]
    nand_us = [us[EXPRS.index(e)] for e in SINGLE_NAND]
    per_expr = float(re.search(r"(\d+) us/expr", tms[-1]).group(1))
    log("console", f"nander console, latency mode, on {card}: {len(res)} res: lines correct "
        f"({len(EXPRS)} expressions, {len(PIPELINED)} pipelined, 1 parse error); "
        f"K3 {launches['k3']} launches = {want_rot} blind rotations, K1 0, K2 "
        f"{launches['k2']} (engine probe); single NAND {', '.join(f'{x:.0f}' for x in nand_us)} us "
        f"per expression; pipelined {per_expr:.0f} us/expr ({len(PIPELINED)} in "
        f"{us[-1] / 1e3:.1f} ms); script {wall:.1f} s with keygen")
    return launches


def phase_latency_real_key(p, dev, seed):
    """K3 on the real latency key, from the real first accumulators of a
    single NAND and a batch of 32, against its plain version and the K1 loop."""
    ctx = TFHE.new(seed, p, device=dev, latency_mode=True)
    bk = ctx.ck.bk.bk
    testvec = trlwe.trivial(torch.full((p.N,), p.mu, dtype=torch.int32, device=dev))
    err = 0
    for b in (1, 32):
        bits = np.arange(2 * b) % 2
        cx, cy = ctx.encrypt(bits[:b]), ctx.encrypt(bits[b:])
        acc, a = bootstrap.rotation_start(gates.precombine("nand", cx, cy, params=p), testvec, p)
        got = rotate_all_k.rotate_all(acc, a, bk, p)
        err = max(err, exact(f"K3 real key B={b} vs plain", got,
                             rotate_all_k.rotate_all_plain(acc, a, bk, p)),
                  exact(f"K3 real key B={b} vs K1 loop", got, k1_loop(acc, a, bk, p)))
        lv0 = bootstrap.identity_key_switch(trlwe.sample_extract(got, 0), ctx.ck.ksk, p)
        check_bits(f"NAND B={b}", ctx.decrypt(lv0).cpu().numpy(), 1 - (bits[:b] & bits[b:]))
    log("latency", "K3 bit-exact against its plain version and the K1 loop on the real "
        "latency key from the real first accumulators (B=1, 32); the NANDs decrypt correctly")
    return err, ctx


def phase_latency_profile(ctx, p, card):
    """The console's single-gate program for one NAND (``1 $ 0``), layer by
    layer (host clock around synchronised work), under torch.profiler."""
    fused = FusedEvaluator(ctx, width=32, max_wires=128)
    _, leaf_bits, _, _, (iab, coeff), root_neg = fused._plan(nander.parse_logic_expr("1 $ 0"))
    leaves = np.full(fused.max_wires, 2, np.uint32)
    leaves[: len(leaf_bits)] = leaf_bits
    nonce = np.zeros(p.n, np.uint32)
    testvec = trlwe.trivial(torch.full((p.N,), p.mu, dtype=torch.int32, device=ctx.device))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    fused.eval_bit(nander.parse_logic_expr("1 $ 0"))  # warm-up
    before = rotate_all_k.rotate_all.launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        wires, t_wires = timed(lambda: fused._init_wires(leaves, nonce))
        idx = fused._index(iab)
        pre, t_pre = timed(lambda: fused._precombine(wires[idx[0]], wires[idx[1]],
                                                     fused._words(coeff)))
        acc, t_rot = timed(lambda: bootstrap.blind_rotate(pre, ctx.ck.bk, testvec, p))
        lv1, t_ext = timed(lambda: trlwe.sample_extract(acc, 0))
        bit, t_dec = timed(lambda: int(tlwe.decrypt_binary(lv1, ctx.sk.lv1)))
        wall = (time.perf_counter() - t0) * 1e3
    if rotate_all_k.rotate_all.launches - before != 1 or bit ^ root_neg != 1:
        raise AssertionError("the profiled single NAND did not run one K3 launch to 1")
    log("breakdown", f"console single NAND on {card}, profiled: wire file {t_wires:.2f} ms, "
        f"precombine {t_pre:.2f} ms, blind rotate {t_rot:.2f} ms (1 K3 launch), sample "
        f"extract {t_ext:.2f} ms, lv1 decrypt {t_dec:.2f} ms; {wall:.2f} ms in all")
    dev_ms = device_times(prof)
    busy = sum(dev_ms.values())
    k3 = sum(v for k, v in dev_ms.items() if "rotate_all_kernel" in k)
    if busy > 0:
        log("profile", f"console single NAND on {card}: device busy {busy:.2f} ms of "
            f"{wall:.2f} ms wall, idle share {1 - busy / wall:.4f}; rotate_all_kernel "
            f"{k3:.2f} ms ({k3 / busy:.2%} of device time); {len(dev_ms)} kernels by name")
    else:
        log("profile", f"console single NAND on {card}: the profiler saw no device time "
            "(device breakdown not measured)")


def main() -> int:
    if len(sys.argv) > 1:
        print("usage: python3 chip_smoke.py  (it takes no arguments)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    p = DEFAULT_PARAMS
    dev = torch.device("cuda", 0)

    # 1. environment
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    nvcc = run([build.nvcc(), "--version"]).splitlines()[-1]
    log("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, {nvcc}; "
        f"device {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
        f"nvidia-smi: {card}")

    # 2. build: one nvcc per source, side by side
    t0 = time.perf_counter()
    libs = build.build()
    cmux_k.load_library()
    rotate_all_k.load_library()
    log("build", f"{', '.join(lib.name for lib, _ in libs.values())} from "
        f"rustfhe_tpu_torch/csrc in {time.perf_counter() - t0:.2f} s")
    for lib, report in libs.values():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("build", "ptxas: " + line.strip())

    # 3. kernels against their plain versions
    rs = np.random.RandomState(SEED)
    errs, times = phase_kernels(p, dev, rs)

    # 4-5. the main path, with the launch counts of this run only
    cmux_k.reset_counters()
    ctx, mixed_pre = phase_main_path(p, dev)
    cx, cy, nand_passes = phase_nand(ctx, p, card)
    passes = 2 + nand_passes
    launches = {"k1": cmux_k.cmux_step.launches, "k2": cmux_k.external_product.launches}
    if launches["k1"] != passes * p.n or launches["k2"] < 1:
        raise AssertionError(f"main path launches {launches}, expected K1 = {passes * p.n} "
                             "and K2 >= 1")
    log("main", f"K1 launched {launches['k1']} times ({passes} passes x {p.n} steps), "
        f"K2 {launches['k2']} (the engine probe)")

    # 6. K1 on the real key, after the main path's counts were read
    nand_pre = gates.precombine("nand", cx, cy, params=p)
    errs["k1"] = max(errs["k1"], phase_real_key(ctx, p, (mixed_pre, nand_pre)))
    del ctx, mixed_pre, cx, cy, nand_pre

    # 7. the latency path: K3 checks and times, then the console with the
    # launch counts of its run only, then K3 on the real latency key
    errs["k3"], k3_times = phase_latency_kernels(p, dev, rs, card)
    lat = phase_console(p, dev, card)
    err, lat_ctx = phase_latency_real_key(p, dev, SEED)
    errs["k3"] = max(errs["k3"], err)
    phase_latency_profile(lat_ctx, p, card)

    kernels = [
        {"name": "cmux_step_k", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "rustfhe_tpu/engine/pallas_k.py:295", "launches": launches["k1"],
         "max_abs_err": errs["k1"], "ms": times["k1"][0], "plain_ms": times["k1"][1]},
        {"name": "external_product_k", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "rustfhe_tpu/engine/pallas_k.py:506", "launches": launches["k2"],
         "max_abs_err": errs["k2"], "ms": times["k2"][0], "plain_ms": times["k2"][1]},
        {"name": "rotate_all_k", "route": "cuda", "source": K3_SOURCE,
         "replaces": "rustfhe_tpu/engine/pallas_k.py:432", "launches": lat["k3"],
         "max_abs_err": errs["k3"], "ms": k3_times[1][0], "plain_ms": k3_times[1][2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
