#!/usr/bin/env python3
"""Drive the port's batched gate bootstrap, its interactive console, its
limb engine, its generic engines, its measurement probes, its
encrypted-integer path, its programmable bootstrapping with the radix
integers, its seeded uploads, its scale-out path, its hybrid keys, its
public-key encryption, its example scripts and its studies once on a CUDA
card.

Run from the repository root, on a host with one NVIDIA H100:

    python3 chip_smoke.py

It takes no arguments.  It imports ``rustfhe_tpu_torch`` and nothing of
JAX, and runs at DEFAULT_PARAMS (n=635, N=1024, l=3, Bg=2^6, key switch
2x8), the reference's ~128-bit parameter set, and (phase 8) at
FAST_PARAMS (l=2, Bg=2^8), with keys and inputs made from seed 0.
Phases, one line each:

  1. environment: torch, CUDA, nvcc, the card;
  2. build: the CUDA kernels from ``rustfhe_tpu_torch/csrc`` (nvcc, first use;
     ptxas's registers, spills and performance notes; K1/K2's, K3's,
     K4/K5/K6's, P5/P6's and P1-P4/P8's kernels may not spill), then the
     host library of ``native.py`` (g++);
  3. kernels: K1 (CMux step: key panel, digits and the int8 wgmma product
     with the limb recombination in its epilogue) and K2 (external
     product: panel and product) on the card against their plain torch
     versions, bit for bit, and K2 against the oracle, on edge inputs and
     at the main path's batches (1024 and 4096); K1's Karatsuba step
     (``cmux_k.cmux_step_karatsuba``, the wide rotations' step: leaf
     panels, tree digits, nine leaf GEMMs, combine) against the plain
     step, and its tree digits, leaf panels and leaves (read back from its
     buffers) and its combine (launched alone) against their plain
     versions, at the same batches; K1's three kernels alone against their
     plain versions; times in turns: K1, its Karatsuba step, its pieces, the plain step,
     and ``torch._int_mm`` at the step's product shape, K1's and the
     Karatsuba step's shares of their bounds; K2 beside its plain version;
  4. main path: ``TFHE.new`` (keygen on the card, K2 probe), one mixed
     bootstrap batch with the NAND/AND/OR/XOR truth tables, NOT and both
     MUX first-pass lanes over all 8 combinations, then the MUX second
     pass; every output decrypted and checked;
  5. timed NAND batch of 4096 gates: decrypt-checked, gates/s, then one
     pass layer by layer under ``torch.profiler`` (K1's three kernels and
     their share of device time, the device's idle share, peak device
     memory, and the SM clock sampled by nvidia-smi during the pass);
  6. K1 on the real bootstrapping key: the first steps of both main-path
     batches' blind rotations, kernel against plain version, bit for bit,
     and one full bootstrap with its rotation issued in one call
     (``cmux_k.cmux_rotate``, at B=4096 on the Karatsuba steps) against the
     per-step loop of ``cmux_step``, and the same rotation on the schoolbook
     steps in one call;
  7. latency path: K3 (the single-launch blind rotation, one cluster per
     sample, the step on the tensor cores) against its plain version and
     the K1 loop over all n steps, bit for bit, on random keys at B = 1, 8,
     32, 33, on clusters of 8 and of 16; K3's time per rotation beside the
     K1 loop's, the plain version's, the latency floor (n cluster barriers
     on K3's cluster shape) and the bound, at B = 1 to 512; the two
     cluster sizes in turns at B = 1 and 16; K3's device time per step and
     its registers; the medians of K3 and the K1 loop over 7 rounds at B =
     4 to 128 (the crossover that sets ``rotate_all_k.MAX_BATCH``); then the
     nander console in latency mode
     (``nander_console(..., latency_mode=True)``) on a fixed script, every
     ``res:`` checked against ``PlainLogic``, with exactly one K3 launch
     per blind rotation at a batch up to ``rotate_all_k.MAX_BATCH`` (the
     root gates, B=1) and one K1 loop per rotation above it (the 32-lane
     levels); then K3 on the real latency key
     from the real first accumulators, and the console's single-NAND
     program layer by layer under ``torch.profiler``;
  8. the limb engine (the JAX engine "pallas"): K4 (merged CMux step), K6
     (c-split step), both K1's int8 wgmma GEMM on panels cut from the limb
     table (K4's tile holds both output halves), and K5 (external product:
     the limb panel and the product without the add, as K2 is K1's)
     against their plain versions, bit for bit (K5 also against the
     oracle), at FAST_PARAMS (l=2, Bg=2^8) and DEFAULT_PARAMS, on the probe
     vectors and random tiles at B = 1, 13, 33, 1024, 4096, K4/K6's three
     kernels alone (limb panel, digits, the product in K4's and K6's tiles)
     at B=4096; their times in turns beside the plain version and K1/K2,
     the three kernels' device time (profiler), the
     product's rate and the share of the bound; K4, K6 and K5 at
     PBS_PARAMS (N=2048, l=4) against the plain step and K1 (K5 against
     its plain version and K2), and their times beside K1 and K2; then
     the FAST_PARAMS path: ``TFHE.new`` picks the
     limb engine, the mixed batch, the MUX second pass and three NAND
     batches run K4 on every step and nothing else, and every lv0 output
     equals that of a K1 context on the same keys (the preset is unsound
     at n=635, so decrypt errors are counted, under a bound); then
     DEFAULT_PARAMS through K4, K6 and K5 per step on phase 4's mixed
     batch, every output decrypted and equal to phase 4's, and the times
     of one K5-per-step step's torch decomposition, K5 and the whole;
  9. the probes (the JAX package's ``benches/`` kernels the port carries):
     P6 (K6's wgmma step without its products or its rotation), P5 (K4's
     step with the fragment drained per plane or once), held to K6 and K4,
     and their own pieces alone (the digits without rotation, the nodots
     kernel, the drain product), P7 and P9 (the int8 GEMM on the tensor
     cores, wgmma on TMA-fed shared memory) against their plain versions,
     word for word, on a limb table mapped from a random JAX-layout ``qd``
     (P6 at B = 1, 13, 33, 8192, "full" also against K6; P5 also against
     K4; P7/P9 at each tile, at the probe shapes 8192 x 6144 x 1024 and
     4096 x 6144 x 8192, at the edges of the kernel's ring (K = DEPTH and
     (STAGES + 1) x DEPTH, one tile, several, and more than the persistent
     grid's blocks, rows and columns of -128), at K = 2^17 - DEPTH all
     -128, and a ragged shape that must raise); their times in turns
     beside the plain versions (the step's breakdown by CUDA events and
     each variant's kernels by the profiler, TOPS beside
     ``torch._int_mm``); then
     the probes' entry points (``rustfhe_tpu_torch.benches``:
     step_breakdown_probe, limb_order_probe, matmul_probe) with their
     defaults, each with the launch counts of its own run;
 10. the Karatsuba step probes (the JAX package's K1 at levels 2 in the
     residue layout; nine leaf GEMMs on wgmma: tree digits, leaf panels,
     the leaf product, the combine): every form of P4 (ablations), P8
     (digit-side variants), P1 (limb-outer), P2 (split tile) and P3 (the
     sum leaves built in the product's producer) against its plain
     version, word for word, at B = 1, 13, 33, 8192 (a~ edges 0, 1, N,
     2N-1, a table mapped from random JAX-layout bytes); the exact forms
     on a table from random rows against K1 through the scan layout; P8's
     two steps per call against two single steps; each piece of every
     form alone against its plain version; every form's time in turns
     beside K1 and the plain step (SM clock sampled), P4's attribution,
     the step / K1 and the share of the bound, P4 full's and K1's kernels
     by the profiler; P4 full at PBS_PARAMS (N=2048, l=4), B=4096, against
     its plain version and K1, then in turns beside K1; then the
     four entry points (k2_floor_probe, vpu_reduce_probe,
     karatsuba2_probe, coissue_probe) with their defaults, each with the
     launch counts of its own run (P3's two forms join the form checks and
     times);
 11. P3 and P10: P3's two forms (the tree planes built per leaf, or
     pipelined) against the production step and the "matmul" engine
     through the scan layout, and their times in turns beside the upfront
     form (A) and K1; P10 (the Nussbaumer primitives) against its plain
     version and the host reference at S = 0, 1, 17, 63 on the probe's
     (128, 2048) tile, on 13 rows and at the transform's size (24576,
     2048), and its device time beside ``out.copy_(x)``'s and the plain
     version's at the probe's tile and the transform's size;
     then the two entry points (coissue2_probe, nussbaumer_primitives_probe)
     at their defaults, each with the launch counts of its own run;
 12. the generic-engine path at DEFAULT_PARAMS: ``TFHE.new(...,
     engine_name="matmul")`` on phase 4's keys, phase 4's mixed batch equal
     word for word to its K1 output, a timed NAND batch (B=4096) with one
     launch of the int8 GEMM (P7/P9's kernel) per step and no K1, one pass
     under ``torch.profiler`` (the idle share), the step's parts and its
     GEMM beside ``torch._int_mm`` and beside K1's step on the same raw
     key (equal word for word); "matmul_bf16", "nuss" and
     "fft64" admitted by the oracle probe on the card and held to
     "matmul" on a random batch; a mixed batch at Bg = 2^9 (l=2, n=64) on
     "matmul_bf16", every output decrypted;
 13. the encrypted-integer path at DEFAULT_PARAMS on phase 4's context and
     keys: the bench's 8-bit adder check through ``evaluate_encrypted``,
     then ``FheUint`` width 8 (+ - * & | ^ ~ << >>, lt/eq/gt, min_/max_,
     select), ``FheInt`` width 8 (the comparisons, abs_, mul_full),
     ``divmod`` with a zero divisor and a 32-bit Kogge-Stone +, on seeded
     operands (256 pairs; fewer for the deep ops), every output decrypted
     against numpy, each op's ms, levels, bootstrap lanes (padding
     counted) and bootstraps/s, and K1 launched n times per bootstrap
     call; then a latency context on the same keys runs an 8-bit + and lt
     at batch 1 and 2 on K3, word for word equal to the K1 loop's, one K3
     launch per bootstrap call and no K1, with the times of a single 8-bit
     add on K3 and on the K1 loop; then ``python3 -m
     rustfhe_tpu_torch.bench`` as a subprocess (BENCH_BATCH=4096,
     BENCH_ITERS=2), its one JSON line checked;
 14. programmable bootstrapping and the radix integers at PBS_PARAMS
     (n=714, N=2048, l=4, Bg=2^6, key switch 4x4) on ``TFHE.new(0,
     PBS_PARAMS)`` ("cmux_k" by the rule: K1 on every step): space-8
     lookups with a table per row at B=16384 (radix_bench's 65536 cut to a
     quarter), chained twice, every lookup decoded (power draw, SM clock
     and the allocator's peak across the pass); ``apply_luts`` (t=2) at
     256 lanes with its decode errors counted; the port radix_bench's ops
     (``radix_bench.OPS``: add, chained add, the bit-circuit add, mul, shl
     2, shl 3, shr 3, x10, ``add_overflows``, the signed full product) at
     256 lanes and
     ``from_pbs_int``, each against numpy with its ms, bootstrap levels
     and lookups; K1 launched n times per bootstrap call; a latency
     context from the same seed runs a radix 8-bit add at batch 1 on K3,
     word for word the K1 loop's; then, after the counts, K1 on the real
     PBS key (steps 0, 1 and n-1 from the B=16384 batch's first
     accumulators, a test vector per row) against its plain version, its
     step times at B=4096 and 16384 beside the bound, and K3 on the real
     latency key at B=1 against the K1 loop, with its time per step;
 15. seeded uploads on phase 4's DEFAULT context and phase 14's PBS
     context: the threefry expansion on the card against the CPU's and
     against mask words pinned from JAX, at n=635 and n=714; the mixed
     truth-table batch from seeded uploads through K1 on a cloud-only
     context, a seeded ``FheUint`` 8-bit + and a seeded ``RadixUint`` add
     at PBS_PARAMS at 256 lanes, expanded cloud-only, every output
     decrypted; an npz round trip with the file sizes; the expansion's
     time and allocator peak at 131072 x 635 mask words;
 16. the scale-out path and hybrid keys: a world of one process on NCCL
     and a (1, 1) mesh on the card, at DEFAULT_PARAMS on phase 4's keys:
     the six sharded gates (``parallel.sharded_gate_fn``) under the model
     all_reduce key switch and the all_to_all key switch at B=4096, each
     equal word for word to the context's gate; ``sharded_bootstrap_fn``
     in turns with the unsharded pass; ``tp_gate_fn`` on "matmul" at
     B=1024 equal to the K1 path (635 P9 launches); ``sharded_pbs_fn`` at
     PBS_PARAMS on phase 14's context equal to ``pbs_many``; a
     ``GateSession`` with its own keygen (an 8-bit ``FheUint`` add at 256
     lanes on K1, and at batch 1 in latency mode on K3); the
     degree-sharded product at N=1024 equal to the "nuss" engine; then
     ``cloud_key_hybrid`` with and without full panels on phase 4's key:
     the timed batch equal to the K1 loop, the panel kernel's launches a
     pass (318 and 0, against 635), the panels' bytes, the allocator's
     peak, and the passes in turns with the standard key's;
 17. public-key encryption on phase 4's DEFAULT context: the key (1272
     zero-encryptions) and its build time, ``encrypt_public`` of 3 x 4096
     bits on a cloud-only context (every bit decrypted, the mask noise
     present, the time beside the byte bound of reading the key once and
     writing the ciphertexts), the six ``gates.hom_*`` on those public
     ciphertexts decrypted right, their first 32 lanes equal word for
     word to the same gates on K1's plain version; then the
     ported examples' ``main()`` at their default knobs (client_server,
     homnand_bench, adder_bench, encrypted_compare, encrypted_ints,
     lut_eval), each to its closing line, with its launches;
 18. the JAX package's studies (``rustfhe_tpu_torch/benches``), each
     through its ``run(out=...)`` with its own checks (every one exact;
     the noise control decodes all right), some at fewer iterations or a
     smaller batch (``STUDIES``, each cut logged), after the host
     library's products against their numpy fallbacks; the launches of
     K1, K2, K3, K4, P4, P8 and P9 counted per study.

Then one JSON line of kernels (each with its time, its bound on the card
and, where one PyTorch call computes the same function, that call's time;
K1's launches count phases 14's, 15's, 16's, 17's and 18's beside the
main path's (with 16's and 18's steps on prebuilt panels), K2's the
engine probes of phase 16's sessions and phase 17's contexts and phase
18's, K3's phases 14's, 16's, 17's and 18's beside the console's, K4's,
P4's and P8's phase 18's beside their own, P9's phase 16's
tensor-parallel pass and phase 18's beside its entry point's; P10's times
are at the transform's size),
the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from rustfhe_tpu_torch import (TFHE, _u32, bootstrap, gates, native, pbs, poly, radix, tlwe,
                               trlwe)
from rustfhe_tpu_torch.apps import nander
from rustfhe_tpu_torch.apps.replprog import FusedEvaluator
from rustfhe_tpu_torch.benches import (_timing, coissue2_probe, coissue_probe, k2_floor_probe,
                                       karatsuba2_probe, limb_order_probe, matmul_probe,
                                       nussbaumer_primitives_probe, step_breakdown_probe,
                                       vpu_reduce_probe)
from rustfhe_tpu_torch.benches._timing import INT8_OPS_PER_S, bound, schoolbook_ops, step_ops
from rustfhe_tpu_torch.engine import (build, cmux_k, get_engine, int8_gemm, karatsuba,
                                      karatsuba_probe, launch, limb_probe, limb_step, matmul,
                                      nuss_primitives, oracle, plain, probe_vectors, rotate_all_k,
                                      select_engine)
from rustfhe_tpu_torch.examples import radix_bench
from rustfhe_tpu_torch.keys import CloudKey, GenericBK
from rustfhe_tpu_torch.params import DEFAULT_PARAMS, FAST_PARAMS, PBS_PARAMS, TFHEParams
from rustfhe_tpu_torch.trgsw import decompose_trlwe
from rustfhe_tpu_torch.utils.timing import time_fn

KERNEL_SOURCE = "rustfhe_tpu_torch/csrc/cmux_k.cu"
KARATSUBA_STEP_SOURCE = "rustfhe_tpu_torch/csrc/karatsuba_step.cuh"  # built into cmux_k.cu
K1_KERNELS = ("key_panel_kernel", "step_digits_kernel", "cmux_product_kernel",  # a step's launches
              "limb_panel_kernel", "leaf_digits_kernel", "leaf_combine_kernel")  # its Karatsuba step's
# (the Karatsuba step's product: cmux_product_kernel<false, 1, LeafProduct<0, 0, 0>>)
# K4/K6's and K5's launches (the digit and product kernels are K1's, csrc/cmux_step.cuh)
LIMB_KERNELS = ("limb_panel_kernel", "step_digits_kernel", "cmux_product_kernel")
K3_KERNELS = ("rotate_all_kernel", "barrier_floor_kernel")
# P5/P6's launches (K4/K6's kernels, the norot digits, the nodots kernel)
PROBE_KERNELS = ("limb_panel_kernel", "step_digits_kernel", "cmux_product_kernel", "nodots_kernel")
# a Karatsuba step's launches (nodots: broadcast_kernel for the product; accio: accio_kernel)
KARATSUBA_KERNELS = ("tree_digits_kernel", "limb_panel_kernel", "cmux_product_kernel",
                     "broadcast_kernel", "combine_kernel", "accio_kernel")
STEP_PIECES = {"panel": "panel_kernel", "digits": "step_digits_kernel",
               "product": "cmux_product_kernel"}  # a K1/K4/K6 step's kernels, by name
K3_SOURCE = "rustfhe_tpu_torch/csrc/rotate_all_k.cu"
LIMB_SOURCE = "rustfhe_tpu_torch/csrc/limb_step.cu"
PROBE_SOURCE = "rustfhe_tpu_torch/csrc/limb_probe.cu"
GEMM_SOURCE = "rustfhe_tpu_torch/csrc/int8_gemm.cu"
KARATSUBA_SOURCE = "rustfhe_tpu_torch/csrc/karatsuba_probe.cu"
NUSS_SOURCE = "rustfhe_tpu_torch/csrc/nuss_primitives.cu"
SEED = 0
MIXED = 1024  # the mixed truth-table batch
BATCH = 4096  # the timed NAND batch
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


def turns(fns: dict, iters: int) -> dict:
    """Device time of each function, timed forward then backward through
    ``fns`` (a, b, c, c, b, a) and averaged over the two turns."""
    order = list(fns) + list(fns)[::-1]
    acc = {k: [] for k in fns}
    for k in order:
        acc[k].append(cuda_ms(fns[k], iters))
    return {k: sum(v) / len(v) for k, v in acc.items()}


def ab_ms(kernel, plain_fn, iters: int) -> tuple[float, float]:
    """Times in turns (plain, kernel, kernel, plain); the mean of each pair."""
    t = turns({"plain": plain_fn, "kernel": kernel}, iters)
    return t["kernel"], t["plain"]


def words(rs, shape, dev):
    return _u32.from_numpy(rs.randint(0, 2**32, size=shape, dtype=np.uint64), dev)


def step_bytes(p, b: int, key_bytes: int) -> int:
    """A CMux step's bytes: the accumulator in and out, a~, the key table."""
    return b * 2 * p.N * 4 * 2 + b * 4 + key_bytes


def phase_kernels(p, dev, rs):
    """K1 and K2 against their plain versions (and K2 against the oracle) at
    DEFAULT_PARAMS, on edge inputs and at the main path's batches, K1's
    Karatsuba step (and its tree digits) at the main path's batches, then
    their times at the main path's shapes."""
    two_l, N = 2 * p.l, p.N
    key = plain.prepare_trgsw(words(rs, (two_l, 2, N), dev))
    ktab = karatsuba.prepare_table(key[..., N:])  # the step's leaf table (cmux_k.leaf_table)
    errs = {"k1": 0, "k2": 0, "k1_karatsuba": 0}

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
    # K1, its Karatsuba step and K2 at the main path's batches: the mixed batch and the NAND
    # batch (the Karatsuba step's tree digits, leaf panels and leaves read back from its
    # buffers, each against its plain version from the step's own inputs to it, and its combine
    # launched alone on those leaves).
    for b in (MIXED, BATCH):
        accb = words(rs, (b, 2, N), dev)
        aib = torch.from_numpy(rs.randint(0, 2 * N, size=b).astype(np.int32)).to(dev)
        want = cmux_k.cmux_step_plain(accb, aib, key, p)
        errs["k1"] = max(errs["k1"], exact(f"K1 B={b}", cmux_k.cmux_step(accb, aib, key, p), want))
        got = cmux_k.cmux_step_karatsuba(accb, aib, ktab, p)
        tree, leaf_panel, leaves = cmux_k.step_buffers("karatsuba", b, p, accb.device,
                                                       launch.current_stream(accb.device))
        errs["k1_karatsuba"] = max(
            errs["k1_karatsuba"], exact(f"K1 Karatsuba B={b}", got, want),
            exact(f"K1 Karatsuba tree digits B={b}", tree,
                  karatsuba_probe.tree_digits_plain(karatsuba.scan_enter(accb), aib, p)),
            exact(f"K1 Karatsuba leaf panels B={b}", leaf_panel,
                  karatsuba_probe.leaf_panel_plain(ktab, p)),
            exact(f"K1 Karatsuba leaves B={b}", leaves,
                  karatsuba_probe.leaves_plain(tree, leaf_panel, ktab, p)),
            exact(f"K1 Karatsuba combine B={b}", cmux_k.leaf_combine(accb, leaves, p), got))
        db = torch.from_numpy(rs.randint(-hb, hb, size=(b, two_l, N)).astype(np.int8)).to(dev)
        errs["k2"] = max(errs["k2"], exact(f"K2 B={b}", cmux_k.external_product(db, key, p),
                                           cmux_k.external_product_plain(db, key)))
    torch.cuda.synchronize()
    log("kernels", f"K1 and K2 bit-exact against their plain versions on {dev} "
        f"(edge inputs, B=256, B={MIXED}, B={BATCH}); K2 equals the oracle on the probe vectors; "
        f"K1's Karatsuba step equals the plain step, and its tree digits, leaf panels, leaves "
        f"and combine (alone) their plain versions, at "
        f"B={MIXED}, B={BATCH}")

    # K1's three kernels alone at B=BATCH, each against its plain version.
    panel = cmux_k.key_panel(key, p)
    exact("K1 key panel", panel, cmux_k.key_panel_plain(key, p))
    digits = cmux_k.step_digits(accb, aib, p)
    exact("K1 digits", digits, cmux_k.step_digits_plain(accb, aib, p))
    exact("K1 product", cmux_k.panel_product(digits, panel, accb, p),
          cmux_k.panel_product_plain(digits, panel, accb, p))
    torch.cuda.synchronize()
    log("kernels", f"K1's pieces at B={BATCH} bit-exact against their plain versions: key panel "
        f"{tuple(panel.shape)} int8, digits {tuple(digits.shape)} int8, product with the "
        "recombination and the add")

    # Times in turns at the main path's shapes: K1, its pieces, the plain
    # step, and torch._int_mm at the step's product shape (its yardstick);
    # K2 at the probe's batch and at B=BATCH.
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    mm_d = torch.randint(-128, 128, (BATCH, two_l * N), dtype=torch.int8, device=dev, generator=gen)
    mm_wt = torch.randint(-128, 128, (2 * 4 * N, two_l * N), dtype=torch.int8, device=dev,
                          generator=gen)
    t = turns({"plain": lambda: cmux_k.cmux_step_plain(accb, aib, key, p),
               "K1": lambda: cmux_k.cmux_step(accb, aib, key, p),
               "Karatsuba": lambda: cmux_k.cmux_step_karatsuba(accb, aib, ktab, p),
               "panel": lambda: cmux_k.key_panel(key, p),
               "digits": lambda: cmux_k.step_digits(accb, aib, p),
               "product": lambda: cmux_k.panel_product(digits, panel, accb, p),
               "torch._int_mm": lambda: torch._int_mm(mm_d, mm_wt.t())}, 10)
    k2_ms, k2_plain = ab_ms(lambda: cmux_k.external_product(pd, pkey, p),
                            lambda: cmux_k.external_product_plain(pd, pkey), 20)
    k2b_ms, k2b_plain = ab_ms(lambda: cmux_k.external_product(db, key, p),
                              lambda: cmux_k.external_product_plain(db, key), 10)
    # Back to back, a short launch's event time is its wrapper's issue time:
    # the pieces' device times come from the profiler.
    dev_t = {k: profiled_ms(t_fn, 20) for k, t_fn in (
        ("K1", lambda: cmux_k.cmux_step(accb, aib, key, p)),
        ("Karatsuba", lambda: cmux_k.cmux_step_karatsuba(accb, aib, ktab, p)),
        ("panel", lambda: cmux_k.key_panel(key, p)),
        ("digits", lambda: cmux_k.step_digits(accb, aib, p)),
        ("product", lambda: cmux_k.panel_product(digits, panel, accb, p)))}
    k1_bound = bound(step_ops(p, BATCH), step_bytes(p, BATCH, two_l * 2 * 2 * N * 4))[0]
    ops = schoolbook_ops(p, BATCH)  # the product's GEMM: BATCH x 2L N x 2 x 4 N
    log("kernels", "K1 pieces, device time (profiler), ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in dev_t.items()))
    log("kernels", f"K1 cmux_step B={BATCH}: {t['K1']:.4f} ms ({t['panel']:.4f} panel + "
        f"{t['digits']:.4f} digits + {t['product']:.4f} product, alone, CUDA events), "
        f"{k1_bound / t['K1']:.1%} of its {k1_bound:.4f} ms bound (the step's least int8 ops, "
        "the Karatsuba count, at the published peak: an estimate); "
        f"plain {t['plain']:.4f} ms; product {ops / t['product'] / 1e9:.1f} TOPS (the GEMM's "
        "schoolbook ops, alone, CUDA events), torch._int_mm "
        f"at the step's product shape {BATCH} x {two_l * N} x {2 * 4 * N} {t['torch._int_mm']:.4f} "
        f"ms ({ops / t['torch._int_mm'] / 1e9:.1f} TOPS) | K2 external_product B={pd.shape[0]} "
        f"(probe): {k2_ms:.4f} ms, plain {k2_plain:.4f} ms | K2 B={BATCH}: {k2b_ms:.4f} ms, "
        f"plain {k2b_plain:.4f} ms")
    kara_bound = bound(step_ops(p, BATCH), step_bytes(p, BATCH, ktab.numel()))[0]
    log("kernels", f"K1 cmux_step_karatsuba B={BATCH}: {t['Karatsuba']:.4f} ms (CUDA events; "
        f"device {dev_t['Karatsuba']:.4f} ms), {t['Karatsuba'] / t['K1']:.3f}x the schoolbook "
        f"step, {kara_bound / t['Karatsuba']:.1%} of its {kara_bound:.4f} ms bound (the leaf "
        f"table's {ktab.numel()} bytes); plain {t['plain']:.4f} ms")
    return errs, {"k1": (t["K1"], t["plain"]), "k2": (k2_ms, k2_plain),
                  "k1_karatsuba": (t["Karatsuba"], t["plain"])}


def ptxas_kernels(report: str, names) -> dict[str, tuple[int, int]]:
    """{kernel: (registers, spill bytes)} from ptxas's -v report of one
    library, the kernels named by ``names`` with the product's template
    arguments (empty when the library came from the build cache)."""
    out, name, spill = {}, None, 0
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = next((k for k in names if k in m.group(1)), m.group(1))
            if t := re.search(r"ILb([01])ELi(\d)E", m.group(1)):
                name += f"<{'true' if t.group(1) == '1' else 'false'}, {t.group(2)}"
                if f := re.search(r"LeafProductILi(\d)ELb([01])ELi(\d)E", m.group(1)):
                    name += f", LeafProduct<{f.group(1)}, {f.group(2)}, {f.group(3)}>"
                elif "5DrainE" in m.group(1):
                    name += ", Drain"
                name += ">"
            elif t := re.search(r"ILi(\d+)EE", m.group(1)):
                name += f"<{t.group(1)}>"
            elif t := re.search(r"ILb([01])EE", m.group(1)):
                name += f"<{'true' if t.group(1) == '1' else 'false'}>"
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out[name] = (int(m.group(1)), spill)
    return out


def check_bits(name: str, got: np.ndarray, want: np.ndarray) -> None:
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"{name}: {bad}/{len(want)} outputs decrypt wrong")


def one_pass(fn, p, kernel=cmux_k.cmux_step):
    """Run one bootstrap pass and check that it launched ``kernel`` (a
    wrapper with a launch count; K1 unless said) once per step."""
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    launched = kernel.launches - before
    if launched != p.n:
        raise AssertionError(f"a bootstrap pass launched {kernel.__name__} {launched} times, "
                             f"expected {p.n}")
    return out


def mixed_batch(ctx, p, encrypt=None):
    """bench.py's mixed truth-table batch of MIXED gates: (segments (op, x
    bits, y bits, pre), the whole pre-combined batch, the MUX combinations,
    the expected bit of every lane).  ``encrypt`` (bits -> ciphertexts)
    defaults to ``ctx.encrypt``."""
    encrypt = encrypt or ctx.encrypt
    seg = MIXED // 8
    segs = []  # (op, x bits, y bits, pre)
    for op in ("nand", "and", "or", "xor"):
        bx = np.tile([0, 1, 0, 1], seg // 4 + 1)[:seg]
        by = np.tile([0, 0, 1, 1], seg // 4 + 1)[:seg]
        segs.append((op, bx, by, gates.precombine(op, encrypt(bx), encrypt(by),
                                                  params=p)))
    bx = np.tile([0, 1], seg // 2 + 1)[:seg]
    cx = encrypt(bx)
    segs.append(("not", bx, bx, gates.precombine("not", cx, params=p)))
    combos = np.array([[c, a, b] for c in (0, 1) for a in (0, 1) for b in (0, 1)])
    mx = np.tile(combos, (seg // 8 + 1, 1))[:seg]
    c_ct, i0_ct, i1_ct = (encrypt(mx[:, k]) for k in range(3))
    segs.append(("mux_a", mx[:, 0], mx[:, 2], gates.precombine("and", c_ct, i1_ct, params=p)))
    segs.append(("mux_b", mx[:, 0], mx[:, 1], gates.precombine("andn", c_ct, i0_ct, params=p)))
    pre = torch.cat([s[3] for s in segs])
    pad = MIXED - pre.shape[0]
    pre = torch.cat([pre, segs[0][3].repeat(pad // seg + 1, 1)[:pad]])
    want = np.concatenate([TRUTH[op](x, y) if op in TRUTH else
                           (x & y if op == "mux_a" else (1 - x) & y) for op, x, y, _ in segs])
    want = np.concatenate([want, np.resize(TRUTH["nand"](segs[0][1], segs[0][2]), pad)])
    return segs, pre, mx, want


def phase_main_path(p, dev):
    """Keygen on the card, then bench.py's mixed truth-table batch and the
    MUX second pass, every output decrypted and checked."""
    t0 = time.perf_counter()
    ctx = TFHE.new(SEED, p, device=dev)
    torch.cuda.synchronize()
    log("main", f"TFHE.new on {dev}: engine {ctx.engine_name} admitted by the K2 oracle "
        f"probe, keys generated in {time.perf_counter() - t0:.2f} s")

    seg = MIXED // 8
    segs, pre, mx, want = mixed_batch(ctx, p)
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
    check_bits("mixed batch", dec, want)
    log("main", f"mixed batch of {MIXED} gates ({seg} each of NAND, AND, OR, XOR, NOT and "
        f"both MUX lanes) in {t_mixed:.3f} s, then the MUX second pass: every output "
        "decrypts correctly (NAND/AND/OR/XOR truth tables, NOT, MUX over all 8 combinations)")
    return ctx, pre, out, want


def sample_card(query: str = "clocks.sm"):
    """Start nvidia-smi sampling the card's ``query`` fields (the SM clock
    in MHz by default; e.g. "power.draw,clocks.sm") every 100 ms."""
    return subprocess.Popen(["nvidia-smi", "-i", "0", f"--query-gpu={query}",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def stop_sampling(proc) -> list[tuple[float, ...]]:
    """Stop a ``sample_card`` process: one tuple of floats per sample."""
    proc.terminate()
    try:
        out, _ = proc.communicate(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    rows = []
    for line in out.splitlines():
        try:
            rows.append(tuple(float(x) for x in line.split(",")))
        except ValueError:
            continue
    return rows


def device_times(prof, counts: dict | None = None) -> dict[str, float]:
    """Self device time (ms) of each kernel the profiler saw on the card;
    into ``counts``, when given, how many launches of each it saw."""
    cuda = torch.autograd.DeviceType.CUDA
    times = {}
    for e in prof.key_averages():
        if e.device_type == cuda:
            times[e.key] = times.get(e.key, 0.0) + e.self_device_time_total / 1e3
            if counts is not None:
                counts[e.key] = counts.get(e.key, 0) + e.count
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
    clock = sample_card()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            pre, t_pre = timed(lambda: gates.precombine("nand", cx, cy, params=p))
            acc, t_rot = timed(lambda: bootstrap.blind_rotate(pre, ctx.ck.bk, testvec, p))
            lv1, t_ext = timed(lambda: trlwe.sample_extract(acc, 0))
            lv0, t_ks = timed(lambda: bootstrap.identity_key_switch(lv1, ctx.ck.ksk, p))
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        mhz = [r[0] for r in stop_sampling(clock)]
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
        k1 = {name: sum(v for k, v in dev_ms.items() if name in k) for name in K1_KERNELS}
        k1_all = sum(k1.values())
        log("profile", f"B={BATCH} on {card}: device busy {busy:.1f} ms of {wall:.1f} ms "
            f"wall, idle share {1 - busy / wall:.4f}; K1 {k1_all:.1f} ms ({k1_all / busy:.2%} "
            "of device time; per step " + ", ".join(f"{k} {v / p.n * 1e3:.1f} us"
                                                    for k, v in k1.items())
            + "); top kernels: " + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top)
            + f"; peak device memory {peak / 2**30:.3f} GiB; {clock_txt}")
    else:
        log("profile", f"B={BATCH} on {card}: the profiler saw no device time (device "
            f"breakdown not measured); peak device memory {peak / 2**30:.3f} GiB; {clock_txt}")
    per_s = 1e3 * p.n / t_rot  # steps per second of wall time
    rate, gemm_rate = step_ops(p, BATCH) * per_s, schoolbook_ops(p, BATCH) * per_s
    log("profile", f"the blind rotation runs {rate / 1e12:.1f} T int8 op/s counted as the step's "
        f"least int8 operations (the Karatsuba count, over its wall time per step): "
        f"{rate / INT8_OPS_PER_S:.1%} of the published 1,979 dense int8 TOP/s (an estimate); "
        f"the GEMM's schoolbook operations run at {gemm_rate / 1e12:.1f} T op/s")
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
    # one full bootstrap, its rotation issued in one call (cmux_k.cmux_rotate: at B=4096 on the
    # Karatsuba steps), against the per-step loop of cmux_step on the same key; and the same
    # rotation on the schoolbook steps in one call
    pre = batches[-1]
    acc, a_steps = bootstrap.rotation_start(pre, testvec, p)
    loop = k1_loop(acc, a_steps, ctx.ck.bk, p)
    want = bootstrap.identity_key_switch(trlwe.sample_extract(loop, 0), ctx.ck.ksk, p)
    product = cmux_k.product_for(p, pre.shape[0])
    k1, rot, kara = (cmux_k.cmux_step.launches, cmux_k.cmux_rotate.launches,
                     cmux_k.cmux_step_karatsuba.launches)
    got = bootstrap.bootstrap(pre, ctx.ck, p)
    if (cmux_k.cmux_step.launches - k1, cmux_k.cmux_rotate.launches - rot) != (p.n, 1):
        raise AssertionError("a bootstrap did not issue its n K1 steps in one cmux_rotate call")
    if cmux_k.cmux_step_karatsuba.launches - kara != (p.n if product == "karatsuba" else 0):
        raise AssertionError(f"a bootstrap of B={pre.shape[0]} did not take the {product} steps")
    err = max(err, exact(f"bootstrap via cmux_rotate ({product}) vs the per-step K1 loop, "
                         f"B={pre.shape[0]}", got, want))
    school = cmux_k.rotate(acc.clone(), a_steps, ctx.ck.bk, p, "schoolbook")
    err = max(err, exact(f"the schoolbook rotation in one call vs the per-step K1 loop, "
                         f"B={pre.shape[0]}", school, loop))
    log("realkey", f"one bootstrap of B={pre.shape[0]} on the bootstrapping key: its rotation in "
        f"one cmux_rotate call ({p.n} {product} steps) = the per-step cmux_step loop, word for "
        "word, and so is the schoolbook rotation in one call")
    return err


# --------------------------------------------------------------------- #
# 7. The latency path: K3 and the nander console in latency mode
# --------------------------------------------------------------------- #
LATENCY_CHECK = (1, 8, 32, 33)            # K3 against plain and K1 loop, bit for bit
LATENCY_TIMES = (1, 2, 4, 8, 16, 32, 128, 256, 512)  # K3 and K1 loop per rotation
PLAIN_TIMES = (1, 8, 32, 128)             # and the plain version
# K3 against the K1 loop, CROSSOVER_REPS runs at each batch: the medians
# set rotate_all_k.MAX_BATCH (the K1 loop's time is the host's, and varies).
CROSSOVER = (4, 8, 16, 32, 64, 128)
CROSSOVER_REPS = 7
CLUSTER_TIMES = (1, 16)  # K3 on clusters of 8 and of 16 blocks, in turns
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


def k3_work(p, b: int) -> tuple[float, int]:
    """(int8 ops, bytes) of a rotation of b samples: the n steps' ops
    (``step_ops``); the accumulator in and out, the rotations and the
    key's q half (the -q half is its negation, and K3 reads only q)."""
    return (step_ops(p, b, p.n),
            b * 2 * 2 * p.N * 4 + p.n * b * 4 + p.n * 2 * p.l * 2 * p.N * 4)


def phase_latency_kernels(p, dev, rs, card, regs):
    """K3 against its plain version and the K1 loop over all n steps, on a
    random key, on both cluster sizes; then its time per rotation beside
    the K1 loop's, the plain version's, the latency floor (n cluster
    barriers on K3's cluster shape) and the bound; the two cluster sizes in
    turns; K3's device time per step (profiler) and its registers."""
    bk = plain.prepare_trgsw(words(rs, (p.n, 2 * p.l, 2, p.N), dev))
    err = 0
    for b in LATENCY_CHECK:
        acc, a = rotation_case(rs, p, b, dev)
        got = rotate_all_k.rotate_all(acc, a, bk, p)
        err = max(err, exact(f"K3 B={b} vs plain", got, rotate_all_k.rotate_all_plain(acc, a, bk, p)),
                  exact(f"K3 B={b} vs K1 loop", got, k1_loop(acc, a, bk, p)))
        for cl in rotate_all_k.CLUSTERS:
            err = max(err, exact(f"K3 B={b} on clusters of {cl}",
                                 rotate_all_k._rotate_all(acc, a, bk, p, cl), got))
    torch.cuda.synchronize()
    log("latency", f"K3 bit-exact against its plain version and the K1 loop over all {p.n} "
        f"steps, random key, B={', '.join(map(str, LATENCY_CHECK))}, on clusters of "
        f"{' and '.join(map(str, rotate_all_k.CLUSTERS))}; the card holds " + ", ".join(
            f"{rotate_all_k.max_clusters(p, cl)} K3 clusters of {cl}"
            for cl in rotate_all_k.CLUSTERS) + " at once")

    times = {}
    for b in LATENCY_TIMES:
        acc, a = rotation_case(rs, p, b, dev)
        k3, k1 = ab_ms(lambda: rotate_all_k.rotate_all(acc, a, bk, p),
                       lambda: k1_loop(acc, a, bk, p), 2)
        pl = cuda_ms(lambda: rotate_all_k.rotate_all_plain(acc, a, bk, p), 1) \
            if b in PLAIN_TIMES else None
        cl = rotate_all_k.cluster_for(b, p, dev)
        floor = cuda_ms(lambda: rotate_all_k.barrier_floor(b, p, dev, cl), 3)
        bnd, by = bound(*k3_work(p, b))
        times[b] = (k3, k1, pl, floor)
        log("latency", f"B={b} on {card}: K3 {k3:.3f} ms per rotation (clusters of {cl}), K1 "
            f"loop {k1:.3f} ms, " + (f"plain {pl:.3f} ms" if pl is not None else
                                      "plain not timed at this batch")
            + f"; latency floor ({p.n} cluster barriers) {floor:.3f} ms; bound {bnd:.4f} ms "
            f"({by})")
    for b in CLUSTER_TIMES:
        acc, a = rotation_case(rs, p, b, dev)
        t = turns({cl: (lambda cl=cl: rotate_all_k._rotate_all(acc, a, bk, p, cl))
                   for cl in rotate_all_k.CLUSTERS}, 3)
        log("latency", f"B={b} on {card}, in turns: K3 " + ", ".join(
            f"{v:.3f} ms on clusters of {k}" for k, v in t.items())
            + f"; rotate_all takes {rotate_all_k.cluster_for(b, p, dev)}")
    acc, a = rotation_case(rs, p, 1, dev)
    seen, counts = profiled_times(lambda: rotate_all_k.rotate_all(acc, a, bk, p), 3)
    k3 = [k for k in seen if "rotate_all_kernel" in k]
    dev_ms = sum(seen[k] for k in k3) / sum(counts[k] for k in k3)  # a session may miss some
    log("profile", f"K3 at B=1 on {card}: device time {dev_ms:.3f} ms per rotation, "
        f"{dev_ms / p.n * 1e3:.2f} us per step (profiler); registers (spill bytes): " + (", ".join(
            f"{k} {r} ({sp})" for k, (r, sp) in regs.items()) if regs else "cached build"))
    crossover_sweep(p, dev, bk, card)
    return err, times


def crossover_sweep(p, dev, bk, card) -> None:
    """K3 and the K1 loop per rotation in turns at each batch of CROSSOVER,
    CROSSOVER_REPS rounds over the batches; the median of each, and the
    largest batch up to which K3's median wins at every batch."""
    rs = np.random.RandomState(SEED + 7)
    runs = {b: [] for b in CROSSOVER}
    for _ in range(CROSSOVER_REPS):
        for b in CROSSOVER:
            acc, a = rotation_case(rs, p, b, dev)
            runs[b].append(ab_ms(lambda: rotate_all_k.rotate_all(acc, a, bk, p),
                                 lambda: k1_loop(acc, a, bk, p), 2))
    med = {b: np.median(np.array(r), axis=0) for b, r in runs.items()}
    wins = [b for b in CROSSOVER if med[b][0] < med[b][1]]
    upto = next((b for b in CROSSOVER if b not in wins), None)
    last = max((b for b in wins if upto is None or b < upto), default=None)
    log("latency", f"crossover on {card}, {CROSSOVER_REPS} rounds, ms per rotation, median "
        "(min-max): " + "; ".join(
            f"B={b} K3 {med[b][0]:.3f} ({min(k for k, _ in r):.3f}-{max(k for k, _ in r):.3f}), "
            f"K1 loop {med[b][1]:.3f} ({min(x for _, x in r):.3f}-{max(x for _, x in r):.3f})"
            for b, r in runs.items())
        + f"; K3's median wins up to B={last}; rotate_all_k.MAX_BATCH = {rotate_all_k.MAX_BATCH}")


CONSOLE_WIDTH = 32  # the fused evaluator's lanes per level on the card


def expected_rotations(script):
    """Blind rotations the console runs for the script, by batch: each
    fused plan's levels run CONSOLE_WIDTH lanes, a single expression's root
    gate one; a constant runs none.  Returns (rotations at B=1, at B=32)."""
    fused = FusedEvaluator(None, width=CONSOLE_WIDTH, max_wires=128)  # planning only
    one, wide = 0, 0
    for line in script:
        if ";" in line:
            asts = [nander.parse_logic_expr(e) for e in line.split(";")]
            plan = fused._plan_many(asts)
            if plan is None:
                raise AssertionError("the pipelined line does not fit the fused evaluator")
            wide += 0 if plan[0] == "const" else len(plan[2])
            continue
        try:
            plan = fused._plan(nander.parse_logic_expr(line))
        except nander.ParseError:
            continue
        if plan is None:
            raise AssertionError(f"{line!r} does not fit the fused evaluator")
        if plan[0] != "const":
            one, wide = one + 1, wide + len(plan[3])
    return one, wide


def phase_console(p, dev, card):
    """The nander console in latency mode on the fixed script: every res:
    line against PlainLogic; one K3 launch per blind rotation at a batch up
    to ``rotate_all_k.MAX_BATCH``, the K1 loop (n launches) per rotation
    above it."""
    plain_logic = nander.PlainLogic()
    script = EXPRS + ["; ".join(PIPELINED), PARSE_ERROR]
    rot = dict(zip((1, CONSOLE_WIDTH), expected_rotations(script)))
    want_k3 = sum(r for b, r in rot.items() if b <= rotate_all_k.MAX_BATCH)
    want_k1 = p.n * sum(r for b, r in rot.items() if b > rotate_all_k.MAX_BATCH)
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
    if launches["k3"] != want_k3 or launches["k1"] != want_k1:
        raise AssertionError(f"console launches {launches}, expected K3 = {want_k3} and K1 = "
                             f"{want_k1} (rotations by batch {rot}, K3 up to B = "
                             f"{rotate_all_k.MAX_BATCH})")

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
        f"blind rotations by batch {rot}: K3 {launches['k3']} launches (B <= "
        f"{rotate_all_k.MAX_BATCH}), K1 {launches['k1']} ({launches['k1'] // p.n} loops of "
        f"{p.n}), K2 {launches['k2']} (engine probe); single NAND "
        f"{', '.join(f'{x:.0f}' for x in nand_us)} us "
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

# --------------------------------------------------------------------- #
# 8. The limb engine: K4, K5 and K6 (the JAX engine "pallas")
# --------------------------------------------------------------------- #
LIMB_CHECK = (1, 13, 33, MIXED, BATCH)  # random tiles, kernel against plain
# FAST_PARAMS is unsound at n=635 (params.py): its decomposition rounding
# makes a few outputs in a thousand decrypt wrong with any exact engine,
# so its gate is word-for-word equality with the K1 path.  A broken
# kernel gives about half wrong; this bound on the share of wrong outputs
# tells the two apart.
FAST_DECRYPT_BOUND = 0.02


def step_piece_ms(fn, calls: int) -> dict[str, float]:
    """Device time (ms) of each of a CMux step's three kernels
    (``STEP_PIECES``: panel, digits, product; one launch each a step) under
    the profiler: the mean over the launches the profiler saw, which in
    some sessions are not all of them."""
    def pieces(per_kernel):
        return {piece: sum(v for k, v in per_kernel.items() if key in k)
                for piece, key in STEP_PIECES.items()}

    times, counts = profiled_times(fn, calls, lambda t, n: min(pieces(n).values()) > 0)
    seen = pieces(counts)
    return {piece: t / seen[piece] for piece, t in pieces(times).items()}


def limb_pieces(p, acc, ai, tab, key, tag) -> None:
    """K4/K6's pieces alone on the card, each against its plain version
    (also on the card): the limb panel (and K1's key panel of the same
    key), the digits, and the product in K4's merged tile and K6's."""
    panel = limb_step.limb_panel(tab, p)
    exact(f"limb panel {tag}", panel, limb_step.limb_panel_plain(tab, p))
    exact(f"limb panel vs K1's key panel {tag}", panel, cmux_k.key_panel(key, p))
    digits = cmux_k.step_digits(acc, ai, p)
    exact(f"digits {tag}", digits, cmux_k.step_digits_plain(acc, ai, p))
    exact(f"K4 merged product {tag}", limb_step.merged_product(digits, panel, acc, p),
          limb_step.merged_product_plain(digits, panel, acc, p))
    exact(f"K6 (K1's) product {tag}", cmux_k.panel_product(digits, panel, acc, p),
          cmux_k.panel_product_plain(digits, panel, acc, p))


def phase_limb_kernels(dev, rs, card, regs):
    """K4, K6 and K5 against their plain versions, bit for bit (K5 also
    against the oracle), at FAST_PARAMS and DEFAULT_PARAMS: the probe
    vectors and random tiles at B = 1, 13, 33, 1024, 4096, and K4/K6's
    three kernels alone at B=4096; K4, K6 and K5 at PBS_PARAMS.  Then
    their times beside the plain version and K1 (K2 for K5) at the same
    shape, the three kernels' device time, the
    product's rate and the share of the bound."""
    errs = {"k4": 0, "k5": 0, "k6": 0}
    times = {}
    for tag, p in (("FAST", FAST_PARAMS), ("DEFAULT", DEFAULT_PARAMS)):
        two_l, N, hb = 2 * p.l, p.N, p.half_bg
        rows_np, digits_np = probe_vectors(p)
        prows = _u32.from_numpy(rows_np, dev)
        ptab = plain.prepare_trgsw_limbs(prows)
        pd = torch.from_numpy(digits_np).to(torch.int8).to(dev)
        got = limb_step.external_product(pd, ptab, p)
        want = oracle.external_product(_u32.from_numpy(rows_np), torch.from_numpy(digits_np))
        errs["k5"] = max(errs["k5"],
                         exact(f"K5 probe {tag}", got, limb_step.external_product_plain(pd, ptab)),
                         exact(f"K5 probe vs oracle {tag}", got, want))
        # K4 and K6 on accumulators made from the probe rows, at edge rotations.
        pacc = prows.repeat(2, 1, 1)[:6].contiguous()
        pai = torch.tensor([0, 1, N - 1, N, N + 1, 2 * N - 1], dtype=torch.int32, device=dev)
        pwant = limb_step.cmux_step_plain(pacc, pai, ptab, p)
        errs["k4"] = max(errs["k4"], exact(f"K4 probe {tag}",
                                           limb_step.cmux_step_merged(pacc, pai, ptab, p), pwant))
        errs["k6"] = max(errs["k6"], exact(f"K6 probe {tag}",
                                           limb_step.cmux_step_split(pacc, pai, ptab, p), pwant))
        rows = words(rs, (two_l, 2, N), dev)
        tab, key = plain.prepare_trgsw_limbs(rows), plain.prepare_trgsw(rows)
        for b in LIMB_CHECK:
            acc = words(rs, (b, 2, N), dev)
            ai = torch.from_numpy(rs.randint(0, 2 * N, size=b).astype(np.int32)).to(dev)
            want = limb_step.cmux_step_plain(acc, ai, tab, p)
            errs["k4"] = max(errs["k4"], exact(f"K4 {tag} B={b}",
                                               limb_step.cmux_step_merged(acc, ai, tab, p), want))
            errs["k6"] = max(errs["k6"], exact(f"K6 {tag} B={b}",
                                               limb_step.cmux_step_split(acc, ai, tab, p), want))
            d = torch.from_numpy(rs.randint(-hb, hb, size=(b, two_l, N)).astype(np.int8)).to(dev)
            errs["k5"] = max(errs["k5"], exact(f"K5 {tag} B={b}",
                                               limb_step.external_product(d, tab, p),
                                               limb_step.external_product_plain(d, tab)))
        limb_pieces(p, acc, ai, tab, key, f"{tag} B={BATCH}")
        torch.cuda.synchronize()
        log("limb", f"{tag}: K4, K6 and K5 bit-exact against their plain versions on {dev} "
            f"(probe vectors, B={', '.join(map(str, LIMB_CHECK))}); K5 equals the oracle on "
            f"the probe vectors; at B={BATCH} the limb panel equals its plain version and K1's "
            "key panel, the digits and both products (K4's merged tile, K6's) their plain versions")

        # Times at the path's shapes: the steps at B=4096, K5 there and at the probe's B=4.
        t = turns({"plain": lambda: limb_step.cmux_step_plain(acc, ai, tab, p),
                   "k1": lambda: cmux_k.cmux_step(acc, ai, key, p),
                   "k4": lambda: limb_step.cmux_step_merged(acc, ai, tab, p),
                   "k6": lambda: limb_step.cmux_step_split(acc, ai, tab, p)}, 5)
        # K5 beside K2
        t5 = turns({"plain": lambda: limb_step.external_product_plain(d, tab),
                    "k2": lambda: cmux_k.external_product(d, key, p),
                    "k5": lambda: limb_step.external_product(d, tab, p)}, 5)
        pkey = plain.prepare_trgsw(prows)
        t5p = turns({"plain": lambda: limb_step.external_product_plain(pd, ptab),
                     "k2": lambda: cmux_k.external_product(pd, pkey, p),
                     "k5": lambda: limb_step.external_product(pd, ptab, p)}, 20)
        pieces = {k: step_piece_ms(fn, 10) for k, fn in (
            ("k4", lambda: limb_step.cmux_step_merged(acc, ai, tab, p)),
            ("k6", lambda: limb_step.cmux_step_split(acc, ai, tab, p)),
            ("k1", lambda: cmux_k.cmux_step(acc, ai, key, p)))}
        times[tag] = {"step": t, "k5": t5, "k5_probe": t5p, "pieces": pieces}
        bnd = bound(step_ops(p, BATCH), step_bytes(p, BATCH, two_l * 2 * 4 * 2 * N))[0]
        ops = schoolbook_ops(p, BATCH)
        log("limb", f"{tag} on {card}, B={BATCH}, ms per step in turns (CUDA events): K4 "
            f"{t['k4']:.4f}, K6 {t['k6']:.4f}, K1 {t['k1']:.4f}, plain {t['plain']:.4f}; share of "
            f"the {bnd:.4f} ms bound (the step's least int8 ops): K4 {bnd / t['k4']:.1%}, K6 "
            f"{bnd / t['k6']:.1%}, K1 {bnd / t['k1']:.1%} | K5 {t5['k5']:.4f}, K2 "
            f"{t5['k2']:.4f}, plain {t5['plain']:.4f} | at B={pd.shape[0]} (probe): K5 "
            f"{t5p['k5']:.4f}, K2 {t5p['k2']:.4f}, plain {t5p['plain']:.4f}")
        log("limb", f"{tag} on {card}, B={BATCH}, device time per step (profiler), ms: "
            + "; ".join(f"{k.upper()} panel {v['panel']:.4f}, digits {v['digits']:.4f}, product "
                        f"{v['product']:.4f} ({ops / v['product'] / 1e9:.1f} TOPS, the GEMM's "
                        "schoolbook ops)" for k, v in pieces.items()))
    if regs:
        log("limb", "K4/K6/K5 kernels from this run's build (registers, spill bytes): " + ", ".join(
            f"{k} {r}, {sp}" for k, (r, sp) in regs.items()))
    times["PBS"] = phase_limb_pbs(dev, rs, card, errs)
    return errs, times


LIMB_PBS_CHECK = (1, 13, 129, MIXED)


def phase_limb_pbs(dev, rs, card, errs) -> dict:
    """K4, K6 and K5 at PBS_PARAMS (N=2048, l=4), which their __dp4a forms
    refused for shared memory: K4 and K6 bit-exact against the plain step
    (on the card) and K1, K5 against its plain version and K2, at B = 1,
    13, 129, 1024; K4, K6 and K1 in turns at B=4096, K5 beside K2."""
    p = PBS_PARAMS
    rows = words(rs, (2 * p.l, 2, p.N), dev)
    tab, key = plain.prepare_trgsw_limbs(rows), plain.prepare_trgsw(rows)
    for b in LIMB_PBS_CHECK:
        acc = words(rs, (b, 2, p.N), dev)
        ai = torch.from_numpy(rs.randint(0, 2 * p.N, size=b).astype(np.int32)).to(dev)
        want = limb_step.cmux_step_plain(acc, ai, tab, p)
        exact(f"K1 PBS B={b}", cmux_k.cmux_step(acc, ai, key, p), want)
        errs["k4"] = max(errs["k4"], exact(f"K4 PBS B={b}",
                                           limb_step.cmux_step_merged(acc, ai, tab, p), want))
        errs["k6"] = max(errs["k6"], exact(f"K6 PBS B={b}",
                                           limb_step.cmux_step_split(acc, ai, tab, p), want))
        d = torch.from_numpy(rs.randint(-128, 128, size=(b, 2 * p.l, p.N)).astype(np.int8)).to(dev)
        got = limb_step.external_product(d, tab, p)
        errs["k5"] = max(errs["k5"], exact(f"K5 PBS B={b}", got,
                                           limb_step.external_product_plain(d, tab)))
        exact(f"K5 PBS B={b} vs K2", got, cmux_k.external_product(d, key, p))
    acc = words(rs, (BATCH, 2, p.N), dev)
    ai = torch.from_numpy(rs.randint(0, 2 * p.N, size=BATCH).astype(np.int32)).to(dev)
    d = torch.from_numpy(rs.randint(-128, 128, size=(BATCH, 2 * p.l, p.N)).astype(np.int8)).to(dev)
    t = turns({"k1": lambda: cmux_k.cmux_step(acc, ai, key, p),
               "k4": lambda: limb_step.cmux_step_merged(acc, ai, tab, p),
               "k6": lambda: limb_step.cmux_step_split(acc, ai, tab, p),
               "k5": lambda: limb_step.external_product(d, tab, p),
               "k2": lambda: cmux_k.external_product(d, key, p)}, 5)
    torch.cuda.synchronize()
    bnd = bound(step_ops(p, BATCH), step_bytes(p, BATCH, 2 * p.l * 2 * 4 * 2 * p.N))[0]
    log("limb", f"PBS_PARAMS (N={p.N}, l={p.l}, Bg=2^{p.bgbit}): K4 and K6 bit-exact against the "
        f"plain step and K1, K5 against its plain version and K2, at B="
        f"{', '.join(map(str, LIMB_PBS_CHECK))}; on {card}, B={BATCH}, ms in turns: K4 "
        f"{t['k4']:.4f}, K6 {t['k6']:.4f}, K1 {t['k1']:.4f} per step, K5 {t['k5']:.4f}, K2 "
        f"{t['k2']:.4f} per product; share of the {bnd:.4f} ms bound: K4 {bnd / t['k4']:.1%}, "
        f"K6 {bnd / t['k6']:.1%}")
    return t


def fast_passes(ctx, p, kernel, pre, nand_in):
    """The FAST path's passes with ``ctx``: the mixed batch, the MUX second
    pass, then the NAND batch (a warm-up and two timed passes).  Each pass
    launches ``kernel`` once per step.  Returns (the outputs, the best
    NAND pass in seconds)."""
    seg = MIXED // 8
    out = one_pass(lambda: ctx.bootstrap_raw(pre), p, kernel)
    pre_or = gates.precombine("or", out[5 * seg: 6 * seg], out[6 * seg: 7 * seg], params=p)
    outs = [out, one_pass(lambda: ctx.bootstrap_raw(pre_or.repeat(MIXED // seg, 1)), p, kernel)]
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        outs.append(one_pass(lambda: ctx.nand(*nand_in), p, kernel))
        if i:
            times.append(time.perf_counter() - t0)
    return outs, min(times)


def phase_fast_path(dev, card):
    """FAST_PARAMS at full width through ``TFHE.new``: the engine rule picks
    the limb engine, every step runs K4 and K5 is the probe; every lv0
    output equals, word for word, that of a K1 context on the same keys."""
    p = FAST_PARAMS
    cmux_k.reset_counters()
    limb_step.reset_counters()
    rotate_all_k.rotate_all.launches = 0
    t0 = time.perf_counter()
    ctx = TFHE.new(SEED, p, device=dev)
    torch.cuda.synchronize()
    probe = limb_step.external_product.launches
    if ctx.engine_name != "limb" or probe < 1:
        raise AssertionError(f"FAST_PARAMS: engine {ctx.engine_name}, {probe} K5 launches")
    log("fast", f"TFHE.new(FAST_PARAMS) on {dev}: engine {ctx.engine_name} admitted by the "
        f"K5 oracle probe, keys in {time.perf_counter() - t0:.2f} s")

    segs, pre, mx, want = mixed_batch(ctx, p)
    pat = np.tile(np.array([[0, 0], [1, 0], [0, 1], [1, 1]]), (BATCH // 4 + 1, 1))[:BATCH]
    nand_in = (ctx.encrypt(pat[:, 0]), ctx.encrypt(pat[:, 1]))
    outs, best = fast_passes(ctx, p, limb_step.cmux_step_merged, pre, nand_in)
    passes = len(outs)
    launches = {"k4": limb_step.cmux_step_merged.launches, "k6": limb_step.cmux_step_split.launches,
                "k5": limb_step.external_product.launches, "k1": cmux_k.cmux_step.launches,
                "k2": cmux_k.external_product.launches, "k3": rotate_all_k.rotate_all.launches}
    if (launches["k4"] != passes * p.n or launches["k5"] != probe
            or any(launches[k] for k in ("k1", "k2", "k3", "k6"))):
        raise AssertionError(f"FAST path launches {launches}, expected K4 = {passes * p.n}, "
                             f"K5 = {probe} (the probe) and no other kernel")

    # Decrypt errors, counted: the mixed lanes, the MUX results, the NAND batches.
    seg = MIXED // 8
    wants = [want, np.resize(np.where(mx[:, 0] == 1, mx[:, 2], mx[:, 1]), MIXED)]
    wants += [1 - (pat[:, 0] & pat[:, 1])] * 3
    wrong = sum(int((ctx.decrypt(o).cpu().numpy() != w).sum()) for o, w in zip(outs, wants))
    total = sum(len(w) for w in wants)
    if wrong >= FAST_DECRYPT_BOUND * total:
        raise AssertionError(f"FAST path: {wrong}/{total} outputs decrypt wrong")

    # The K1 path on the same raw keys: the same seed draws the same words.
    k1 = TFHE.new(SEED, p, device=dev, engine_name="cmux_k")
    if not (torch.equal(k1.sk.lv0, ctx.sk.lv0) and torch.equal(k1.ck.ksk, ctx.ck.ksk)
            and torch.equal(plain.prepare_trgsw_limbs(k1.ck.bk[..., p.N:]), ctx.ck.bk.table)):
        raise AssertionError("the K1 context's keys differ from the limb context's")
    k1_outs, k1_best = fast_passes(k1, p, cmux_k.cmux_step, pre, nand_in)
    for i, (a, b) in enumerate(zip(outs, k1_outs)):
        exact(f"FAST pass {i}: limb engine vs K1", a, b)
    log("fast", f"FAST_PARAMS (n={p.n}, N={p.N}, l={p.l}, Bg=2^{p.bgbit}) on {card}: "
        f"{passes} passes (mixed {MIXED} + MUX second pass + 3 NAND x {BATCH}); K4 "
        f"{launches['k4']} launches = {passes} x {p.n}, K5 {probe} (probe), K1/K2/K3/K6 0; "
        f"every lv0 output equals the K1 path's word for word; {wrong}/{total} outputs "
        f"decrypt wrong (bound {FAST_DECRYPT_BOUND:.0%}); NAND B={BATCH}: limb "
        f"{BATCH / best:.1f} gates/s ({best * 1e3:.1f} ms), K1 {BATCH / k1_best:.1f} gates/s "
        f"({k1_best * 1e3:.1f} ms)")
    return launches


def phase_default_limb(dev, card, mixed_pre, mixed_out, mixed_want):
    """DEFAULT_PARAMS through the limb engine chosen by name, on phase 4's
    mixed batch: one pass each of K4, K6 (merge_c=False) and K5 per step
    (fuse_step=False); every output decrypts correctly and all three equal
    phase 4's K1 output word for word.  Then one fuse_step=False step's
    pieces, timed."""
    p = DEFAULT_PARAMS
    cmux_k.reset_counters()
    limb_step.reset_counters()
    ctx = TFHE.new(SEED, p, device=dev, engine_name="limb")
    probe = limb_step.external_product.launches
    wall = {}
    forms = {"K4": (ctx.ck, limb_step.cmux_step_merged),
             "K6": (CloudKey(dataclasses.replace(ctx.ck.bk, merge_c=False), ctx.ck.ksk),
                    limb_step.cmux_step_split),
             "K5 per step": (CloudKey(dataclasses.replace(ctx.ck.bk, fuse_step=False),
                                      ctx.ck.ksk), limb_step.external_product)}
    for form, (ck, kernel) in forms.items():
        t0 = time.perf_counter()
        out = one_pass(lambda: gates.hom_bootstrap(ck, mixed_pre, params=p), p, kernel)
        wall[form] = time.perf_counter() - t0
        check_bits(f"DEFAULT limb {form}", ctx.decrypt(out).cpu().numpy(), mixed_want)
        exact(f"DEFAULT limb {form} vs K1", out, mixed_out)
    launches = {"k4": limb_step.cmux_step_merged.launches, "k6": limb_step.cmux_step_split.launches,
                "k5": limb_step.external_product.launches, "k1": cmux_k.cmux_step.launches}
    if launches != {"k4": p.n, "k6": p.n, "k5": p.n + probe, "k1": 0}:
        raise AssertionError(f"DEFAULT limb launches {launches}, expected K4 = K6 = {p.n}, "
                             f"K5 = {p.n} + {probe} (probe), no K1")
    log("limb", f"DEFAULT_PARAMS, engine limb by name, on {card}: the mixed batch of {MIXED} "
        "through K4, K6 (merge_c=False) and K5 per step (fuse_step=False): every output "
        "decrypts correctly and equals phase 4's K1 output word for word; launches "
        f"{launches}; pass " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in wall.items()))

    # One fuse_step=False step at the pass's batch, in turns (after the
    # counts): the torch rotation, difference and decomposition alone, K5
    # alone on their digits, and the whole step as _limb_rotate runs it.
    rs = np.random.RandomState(SEED)
    acc = words(rs, (MIXED, 2, p.N), dev)
    ai = torch.from_numpy(rs.randint(0, 2 * p.N, size=MIXED).astype(np.int32)).to(dev)
    table = ctx.ck.bk.table[0]

    def torch_digits():
        return decompose_trlwe(poly.rotate(acc, ai[:, None]) - acc, p).to(torch.int8)

    d = torch_digits()
    t = turns({"torch": torch_digits, "k5": lambda: limb_step.external_product(d, table, p),
               "step": lambda: acc + limb_step.external_product(torch_digits(), table, p)}, 20)
    log("limb", f"DEFAULT_PARAMS on {card}, one fuse_step=False step at B={MIXED}, ms in turns "
        f"(CUDA events): torch rotation + decomposition {t['torch']:.4f}, K5 {t['k5']:.4f}, the "
        f"step {t['step']:.4f}")
    return launches


# --------------------------------------------------------------------- #
# 9. The probes: P5, P6 (limb_probe), P7, P9 (int8_gemm)
# --------------------------------------------------------------------- #
PROBE_CHECK = (1, 13, 33, 8192)  # P6 and P5 against their plain versions
GEMM_SHAPES = {"p7": (8192, 6144, 1024), "p9": (4096, 6144, 8192)}  # (M, K, N)
EDGE_K = (1 << 17) - int8_gemm.DEPTH  # every product -128 * -128: sums of 2^31 - 2^21


def device_int8(gen, shape, dev):
    return torch.randint(-128, 128, shape, dtype=torch.int8, device=dev, generator=gen)


def gemm_edges(dev, gen) -> int:
    """The GEMM at every tile against the float64 product on the shapes at
    the edges of its ring: K = DEPTH (one stage), K = (STAGES + 1) x DEPTH
    (the ring wraps), M and N one tile and several, more tiles than the
    persistent grid has blocks at K = (STAGES + 1) x DEPTH (a block's next
    tile starts in the middle of a round of the ring), a row and a column of
    -128 (the largest products), and K = 2^17 - DEPTH all -128 (the
    exactness edge).  Returns the largest error (0, or it raised)."""
    err = 0
    depth, stages = int8_gemm.DEPTH, int8_gemm.STAGES
    for tile in int8_gemm.TILES:
        bm, bn = int8_gemm.tile_shape(tile)
        wraps = (stages + 1) * depth
        for M, K, N in ((bm, depth, bn), (bm, wraps, bn), (3 * bm, wraps, 2 * bn),
                        (2 * bm, 6144, 3 * bn), (2048, wraps, 4096)):
            d, w = device_int8(gen, (M, K), dev), device_int8(gen, (K, N), dev)
            d[M // 2], w[:, N // 2] = -128, -128
            err = max(err, exact(f"GEMM {tile} {M} x {K} x {N}", int8_gemm.int8_matmul(
                d, int8_gemm.prepare_rhs(w), tile), int8_gemm.int8_matmul_plain(d, w)))
        d = torch.full((bm, EDGE_K), -128, dtype=torch.int8, device=dev)
        wt = torch.full((bn, EDGE_K), -128, dtype=torch.int8, device=dev)
        err = max(err, exact(f"GEMM {tile} at K = {EDGE_K}", int8_gemm.int8_matmul(d, wt, tile),
                             torch.full((bm, bn), EDGE_K * 16384, dtype=torch.int32)))
    return err


def phase_probe_kernels(dev, rs, card):
    """P6's three variants and P5's two orders (K6's and K4's tensor-core
    step with one part changed) against their plain versions (and K6, K4),
    word for word, at DEFAULT_PARAMS on a limb table mapped from a random
    JAX-layout qd, and their own pieces alone (the digits without rotation,
    P5's drain product, P6's nodots kernel); P7/P9 at every tile against
    the float64 product at the probe shapes and the ring's edges, and a
    ragged shape refused.  Then the times in turns: the step's breakdown
    (CUDA events, and each variant's kernels by the profiler) and the
    GEMM's TOPS at each tile."""
    p = DEFAULT_PARAMS
    errs = {"p5": 0, "p6": 0, "p7": 0, "p9": 0}
    qd = torch.from_numpy(rs.randint(-128, 128, size=(2, 2 * p.l * 4, 2 * p.N)).astype(np.int8))
    tab = plain.limb_table_from_qd(qd).to(dev)
    for b in PROBE_CHECK:
        acc = words(rs, (b, 2, p.N), dev)
        ai = torch.from_numpy(rs.randint(0, 2 * p.N, size=b).astype(np.int32)).to(dev)
        ai[: min(b, 4)] = torch.tensor([0, 1, p.N, 2 * p.N - 1], dtype=torch.int32)[: min(b, 4)]
        for v, (rot, dots) in limb_probe.VARIANTS.items():
            got = limb_probe.step_variant(acc, ai, tab, p, v)
            errs["p6"] = max(errs["p6"], exact(f"P6 {v} B={b}", got, limb_probe.variant_step_plain(
                acc, ai, tab, p, rot, dots)))
            if v == "full":
                exact(f"P6 full vs K6 B={b}", got, limb_step.cmux_step_split(acc, ai, tab, p))
        k4 = limb_step.cmux_step_merged(acc, ai, tab, p)
        want = limb_step.cmux_step_plain(acc, ai, tab, p)  # P5's plain version is K4's
        for order in limb_probe.ORDERS:
            got = limb_probe.step_order(acc, ai, tab, p, order)
            errs["p5"] = max(errs["p5"], exact(f"P5 {order} B={b}", got, want))
            exact(f"P5 {order} vs K4 B={b}", got, k4)
    # the probes' own pieces alone at B=8192 (acc, ai of the last check)
    norot = limb_probe.step_digits(acc, ai, p, rotate=False)
    errs["p6"] = max(errs["p6"], exact("P6 norot digits", norot, limb_probe.step_digits_plain(
        acc, ai, p, rotate=False)))
    digits, panel = cmux_k.step_digits(acc, ai, p), limb_step.limb_panel(tab, p)
    errs["p6"] = max(errs["p6"], exact("P6 nodots kernel", limb_probe.nodots(digits, acc, p),
                                       limb_probe.nodots_plain(digits, acc, p)))
    errs["p5"] = max(errs["p5"], exact("P5 drain product", limb_probe.drain_product(
        digits, panel, acc, p), limb_step.merged_product_plain(digits, panel, acc, p)))
    torch.cuda.synchronize()
    log("probes", f"P6 (full, nodots, norot) and P5 (j-outer, limb-outer), K6's and K4's wgmma "
        f"step with one part changed, bit-exact against their plain versions at "
        f"B={', '.join(map(str, PROBE_CHECK))}; P6 full equals K6, both P5 orders equal K4; "
        f"at B={acc.shape[0]} the digits without rotation, the nodots kernel and the drain "
        "product equal their plain versions")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    gemm = {}
    for key, (M, K, N) in GEMM_SHAPES.items():
        d, w = device_int8(gen, (M, K), dev), device_int8(gen, (K, N), dev)
        wt = int8_gemm.prepare_rhs(w)
        want = int8_gemm.int8_matmul_plain(d, w)
        for tile in int8_gemm.TILES:
            errs[key] = max(errs[key], exact(f"{key.upper()} tile {tile}",
                                             int8_gemm.int8_matmul(d, wt, tile), want))
            try:
                int8_gemm.int8_matmul(d[: M - 8], wt, tile)
            except ValueError:
                pass
            else:
                raise AssertionError(f"{key.upper()} tile {tile}: a ragged M = {M - 8} ran")
        gemm[key] = (d, w, wt)
    edge = gemm_edges(dev, gen)
    errs["p7"], errs["p9"] = max(errs["p7"], edge), max(errs["p9"], edge)
    torch.cuda.synchronize()
    log("probes", "P7 (8192 x 6144 x 1024) and P9 (4096 x 6144 x 8192) bit-exact against the "
        f"float64 product at every tile ({', '.join(int8_gemm.TILES)}); a ragged M raises; "
        f"bit-exact at the ring's edges (K = {int8_gemm.DEPTH}, "
        f"{(int8_gemm.STAGES + 1) * int8_gemm.DEPTH}, one tile, several, more than the grid's "
        f"blocks, -128 rows and columns), and at K = {EDGE_K}, all -128, every sum "
        f"{EDGE_K * 16384}")

    # The step's breakdown at the probe's B=8192 (acc, ai of the last check).
    step = {"plain": lambda: limb_step.cmux_step_plain(acc, ai, tab, p),
            "K6": lambda: limb_step.cmux_step_split(acc, ai, tab, p),
            "K4": lambda: limb_step.cmux_step_merged(acc, ai, tab, p),
            **{f"P6 {v}": (lambda v=v: limb_probe.step_variant(acc, ai, tab, p, v))
               for v in limb_probe.VARIANTS},
            **{f"P5 {o}": (lambda o=o: limb_probe.step_order(acc, ai, tab, p, o))
               for o in limb_probe.ORDERS}}
    t = turns(step, 5)
    log("probes", f"limb step at DEFAULT, B={acc.shape[0]}, on {card}, ms/step (CUDA events, "
        "in turns): " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
        + f" | rotation (P6 full - norot) {t['P6 full'] - t['P6 norot']:.4f}, products (P6 full"
        f" - nodots) {t['P6 full'] - t['P6 nodots']:.4f}, the rest (nodots) "
        f"{t['P6 nodots']:.4f}; recombination per plane (P5 j-outer - limb-outer) "
        f"{t['P5 j-outer'] - t['P5 limb-outer']:.4f}; P6 full / K6 {t['P6 full'] / t['K6']:.4f}, "
        f"P5 limb-outer / K4 {t['P5 limb-outer'] / t['K4']:.4f}")
    split = {k: profiled_times(step[k], 10)[0] for k in
             ("P6 full", "P6 norot", "P6 nodots", "P5 limb-outer", "P5 j-outer")}
    log("probes", "device time per step by kernel (profiler, 10 steps), ms: " + "; ".join(
        f"{k}: " + ", ".join(f"{kernel_label(n)} {v / 10:.4f}" for n, v in sorted(d.items()))
        for k, d in split.items()))
    vplain = {v: cuda_ms(lambda rd=rd: limb_probe.variant_step_plain(acc, ai, tab, p, *rd), 2)
              for v, rd in limb_probe.VARIANTS.items() if v != "full"}
    log("probes", "plain P6 variants, ms: " + ", ".join(f"{k} {v:.4f}" for k, v in vplain.items()))

    gt = {}
    for key, (d, w, wt) in gemm.items():
        M, K = d.shape
        fns = {"plain": lambda d=d, w=w: int8_gemm.int8_matmul_plain(d, w),
               "torch._int_mm": lambda d=d, wt=wt: torch._int_mm(d, wt.t()),
               **{tile: (lambda d=d, wt=wt, tile=tile: int8_gemm.int8_matmul(d, wt, tile))
                  for tile in int8_gemm.TILES}}
        gt[key] = turns(fns, 10)
        N = w.shape[1]
        ops = 2 * M * K * N
        best = min(gt[key][x] for x in int8_gemm.TILES)
        log("probes", f"{key.upper()} {M} x {K} x {N} on {card}: "
            + ", ".join(f"{k} {v:.4f} ms ({ops / v / 1e9:.1f} TOPS)" for k, v in gt[key].items())
            + "; estimate against the published 1,979 dense int8 TOP/s: best tile "
            f"{ops / best / 1e9 / 1979:.1%} (bound {bound(ops, M * K + K * N + 4 * M * N)[0]:.4f} "
            f"ms), torch._int_mm {ops / gt[key]['torch._int_mm'] / 1e9 / 1979:.1%}")
    return errs, t, gt


def phase_probe_entry_points(card):
    """The probes' entry points with their defaults, as a user runs them
    (``python -m rustfhe_tpu_torch.benches.<name>``), each with the launch
    counts of its own run."""
    logp = functools.partial(log, "probes")
    chained = _timing.STEPS * _timing.REPS + 1  # launches per timed line, the warm-up included
    launches = {}
    limb_probe.reset_counters()
    int8_gemm.reset_counters()
    step_breakdown_probe.run(out=logp)
    launches["p6"] = limb_probe.step_variant.launches
    launches["p7"] = int8_gemm.int8_matmul.launches
    limb_probe.reset_counters()
    int8_gemm.reset_counters()
    limb_order_probe.run(out=logp)
    launches["p5"] = limb_probe.step_order.launches
    limb_probe.reset_counters()
    int8_gemm.reset_counters()
    matmul_probe.run(out=logp)
    launches["p9"] = int8_gemm.int8_matmul.launches
    tiles = len(int8_gemm.TILES)
    want = {"p6": 3 * chained, "p7": tiles * chained, "p5": 4 * chained, "p9": tiles * chained}
    if launches != want:
        raise AssertionError(f"probe entry points launched {launches}, expected {want}")
    log("probes", f"entry points at their defaults on {card}: launches {launches} "
        f"({chained} per timed line)")
    return launches


# --------------------------------------------------------------------- #
# 10. The Karatsuba step probes: P4, P8, P1, P2 (karatsuba_probe)
# --------------------------------------------------------------------- #
KARATSUBA_REPLACES = {"P4": "benches/k2_floor_probe.py:164", "P8": "benches/vpu_reduce_probe.py:190",
                      "P1": "benches/karatsuba2_probe.py:179", "P2": "benches/coissue_probe.py:114",
                      "P3": "benches/coissue2_probe.py:134"}


KARATSUBA_PIECES = {"tree digits": "tree_digits_kernel", "leaf panels": "limb_panel_kernel",
                    "leaf product": "cmux_product_kernel", "combine": "combine_kernel"}
KARATSUBA_PBS_B = 4096  # the Karatsuba step beside K1 at PBS_PARAMS


def karatsuba_pieces(flat, ai, tab, p, dev) -> int:
    """Each piece of every form alone on the card against its plain version
    (also on the card): the tree digits (P3's forms: the residue leaves),
    the leaf panels, the leaves (on every leaf's digits) and the combine.
    Returns the largest error (0, or it raised)."""
    err = exact("leaf panels", karatsuba_probe.leaf_panel(tab, p),
                karatsuba_probe.leaf_panel_plain(tab, p))
    panel = karatsuba_probe.leaf_panel_plain(tab, p)
    for form in sorted(karatsuba_probe.FORMS - {karatsuba_probe.ABLATIONS["accio"]}, key=str):
        want = karatsuba_probe.tree_digits_plain(flat, ai, p, form)
        got = karatsuba_probe.tree_digits(flat, ai, p, form)
        if form.build != "upfront":
            got, want = (x[:, list(karatsuba_probe.RESIDUE_LEAVES)] for x in (got, want))
        err = max(err, exact(f"tree digits {form}", got, want))
        dig = karatsuba_probe.tree_digits_plain(flat, ai, p, form)
        leaves = karatsuba_probe.leaves(dig, panel, tab, p, form)
        err = max(err, exact(f"leaves {form}", leaves,
                             karatsuba_probe.leaves_plain(dig, panel, tab, p, form)))
        err = max(err, exact(f"combine {form}", karatsuba_probe.combine(flat, leaves, p, form),
                             karatsuba_probe.combine_plain(flat, leaves, p, form)))
    return err


def karatsuba_split(fn, calls: int = 10) -> dict[str, float]:
    """Device time (ms) per step of each of a Karatsuba step's kernels
    (``KARATSUBA_PIECES``) under the profiler."""
    times, _ = profiled_times(fn, calls, lambda t, n: all(
        any(k in name for name in n) for k in KARATSUBA_PIECES.values()))
    return {piece: sum(v for n, v in times.items() if k in n) / calls
            for piece, k in KARATSUBA_PIECES.items()}


def phase_karatsuba_kernels(dev, rs, card):
    """Every form of P4, P8, P1, P2 and P3 against its plain version, word
    for word, at B = 1, 13, 33, 8192 on a table mapped from random
    JAX-layout bytes; the exact forms on a table from random rows against
    K1 through the scan layout; P8's two steps per call against two single
    steps; each piece of every form alone against its plain version at
    B=8192.  Then every form's time in turns at B=8192 beside K1 and the
    plain step (the SM clock sampled), the share of the bound, and P4
    full's kernels by the profiler."""
    p = DEFAULT_PARAMS
    errs = dict.fromkeys(KARATSUBA_REPLACES, 0)
    qd = torch.from_numpy(rs.randint(-128, 128, size=(2, 2 * p.l * 4 * 9, p.N // 2)).astype(np.int8))
    tab = karatsuba.table_from_qd(qd).to(dev)
    rows = words(rs, (2 * p.l, 2, p.N), dev)
    rtab, key = karatsuba.prepare_table(rows), plain.prepare_trgsw(rows)
    calls = karatsuba_probe.calls()
    for b in PROBE_CHECK:
        std = words(rs, (b, 2, p.N), dev)
        ai = torch.from_numpy(rs.randint(0, 2 * p.N, size=b).astype(np.int32)).to(dev)
        ai[: min(b, 4)] = torch.tensor([0, 1, p.N, 2 * p.N - 1], dtype=torch.int32)[: min(b, 4)]
        flat = karatsuba.scan_enter(std)
        for probe, label, fn, kw, form in calls:
            errs[probe] = max(errs[probe], exact(f"{probe} {label} B={b}", fn(flat, ai, tab, p, **kw),
                                                 karatsuba.step_plain(flat, ai, tab, p, form)))
        k1 = cmux_k.cmux_step(std, ai, key, p)
        for probe, label, fn, kw, form in calls:
            if form.exact:
                exact(f"{probe} {label} vs K1 B={b}", karatsuba.scan_exit(fn(flat, ai, rtab, p, **kw)),
                      k1)
        a2 = torch.stack([ai, ai.flip(0)], dim=1)
        one = karatsuba_probe.step_var(flat, ai, tab, p)
        exact(f"P8 unroll2 B={b}", karatsuba_probe.step_var(flat, a2, torch.stack([tab, rtab]), p,
                                                          unroll=2),
              karatsuba_probe.step_var(one, ai.flip(0).contiguous(), rtab, p))
    piece_err = karatsuba_pieces(flat, ai, tab, p, dev)
    errs = {k: max(v, piece_err) for k, v in errs.items()}
    torch.cuda.synchronize()
    log("karatsuba", f"{len(calls)} forms (P4 {len(karatsuba_probe.ABLATIONS)}, P8 "
        f"{len(karatsuba_probe.VAR_FORMS)}, P1 1, P2 2, P3 2) bit-exact against their plain "
        f"versions at B={', '.join(map(str, PROBE_CHECK))}; P4 full, every exact P8 form, P1, "
        "both P2 orders and both P3 forms equal K1 through the scan layout; P8 unroll2 equals "
        f"two single steps; at B={flat.shape[0]} every form's tree digits, leaf panels, leaves "
        "and combine equal their plain versions")

    # Times at the probes' B=8192 (std, flat, ai of the last check), on the rows' table.
    a2 = torch.stack([ai, ai], dim=1)
    rtabs = torch.stack([rtab, rtab])
    fns = {"plain": lambda: karatsuba.step_plain(flat, ai, rtab, p),
           "K1": lambda: cmux_k.cmux_step(std, ai, key, p),
           **{f"{probe} {label}": (lambda fn=fn, kw=kw: fn(flat, ai, rtab, p, **kw))
              for probe, label, fn, kw, _ in calls},
           "P8 unroll2 (2 steps)": lambda: karatsuba_probe.step_var(flat, a2, rtabs, p, unroll=2)}
    for fn in fns.values():  # a warm-up round: the card at its working clock
        fn()
    clock = sample_card()
    t = turns(fns, 5)
    mhz = [r[0] for r in stop_sampling(clock)]
    b = flat.shape[0]
    bnd = bound(step_ops(p, b), step_bytes(p, b, int(np.prod(karatsuba.table_shape(p)))))[0]
    clock_text = (f"SM clock {min(mhz):.0f}-{max(mhz):.0f} MHz (mean {np.mean(mhz):.0f}, "
                  f"{len(mhz)} samples)" if mhz else "SM clock not measured")
    log("karatsuba", f"Karatsuba step at DEFAULT, B={b}, on {card}, ms/step (CUDA events, in "
        "turns): " + ", ".join(f"{k} {v:.4f}" for k, v in t.items() if k != "P8 unroll2 (2 steps)")
        + f", P8 unroll2 {t['P8 unroll2 (2 steps)'] / 2:.4f} (two steps); {clock_text}")
    log("karatsuba", "P4 attribution (full - variant), ms: " + ", ".join(
        f"{v} {t['P4 full'] - t[f'P4 {v}']:+.4f}" for v in karatsuba_probe.ABLATIONS if v != "full")
        + f" | Karatsuba step / K1: {t['P4 full'] / t['K1']:.3f}; share of the {bnd:.4f} ms "
        f"bound: P4 full {bnd / t['P4 full']:.1%}, K1 {bnd / t['K1']:.1%}")
    split = karatsuba_split(fns["P4 full"])
    k1_split = step_piece_ms(fns["K1"], 10)
    log("karatsuba", f"P4 full's kernels, device time per step (profiler), ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items()) + f" (sum {sum(split.values()):.4f}); the leaf "
        f"product at {step_ops(p, b) / split['leaf product'] / 1e9:.1f} TOPS (the Karatsuba "
        "ops) | K1's: " + ", ".join(f"{k} {v:.4f}" for k, v in k1_split.items())
        + f" ({schoolbook_ops(p, b) / k1_split['product'] / 1e9:.1f} TOPS, the schoolbook ops)")
    return errs, t, b


def phase_karatsuba_pbs(dev, rs, card):
    """The Karatsuba step at PBS_PARAMS (N=2048, l=4), B=4096: P4 full
    against its plain version and K1 through the scan layout, word for
    word, then P4 full, K1 and the plain step in turns, the share of the
    bound, and P4 full's kernels by the profiler."""
    p, b = PBS_PARAMS, KARATSUBA_PBS_B
    karatsuba.check_bound(p)
    rows = words(rs, (2 * p.l, 2, p.N), dev)
    tab, key = karatsuba.prepare_table(rows), plain.prepare_trgsw(rows)
    std = words(rs, (b, 2, p.N), dev)
    ai = torch.from_numpy(rs.randint(0, 2 * p.N, size=b).astype(np.int32)).to(dev)
    ai[:4] = torch.tensor([0, 1, p.N, 2 * p.N - 1], dtype=torch.int32)
    flat = karatsuba.scan_enter(std)
    got = karatsuba_probe.step_ablate(flat, ai, tab, p, "full")
    err = exact("P4 full PBS", got, karatsuba.step_plain(flat, ai, tab, p))
    exact("P4 full PBS vs K1", karatsuba.scan_exit(got), cmux_k.cmux_step(std, ai, key, p))
    torch.cuda.synchronize()
    fns = {"plain": lambda: karatsuba.step_plain(flat, ai, tab, p),
           "K1": lambda: cmux_k.cmux_step(std, ai, key, p),
           "P4 full": lambda: karatsuba_probe.step_ablate(flat, ai, tab, p, "full")}
    for fn in fns.values():
        fn()
    clock = sample_card()
    t = turns(fns, 5)
    mhz = [r[0] for r in stop_sampling(clock)]
    bnd = bound(step_ops(p, b), step_bytes(p, b, int(np.prod(karatsuba.table_shape(p)))))[0]
    split = karatsuba_split(fns["P4 full"])
    log("karatsuba", f"PBS_PARAMS (N={p.N}, l={p.l}), B={b}: P4 full equals its plain version "
        f"and K1 through the scan layout; on {card}, ms/step in turns (CUDA events): P4 full "
        f"{t['P4 full']:.4f}, K1 {t['K1']:.4f}, plain {t['plain']:.4f}; Karatsuba step / K1: "
        f"{t['P4 full'] / t['K1']:.3f}; share of the {bnd:.4f} ms bound: P4 full "
        f"{bnd / t['P4 full']:.1%}, K1 {bnd / t['K1']:.1%}; SM clock "
        + (f"{min(mhz):.0f}-{max(mhz):.0f} MHz (mean {np.mean(mhz):.0f})" if mhz else
           "not measured") + " | P4 full's kernels (profiler), ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return err, t


def phase_karatsuba_entry_points(card):
    """The four entry points with their defaults, as a user runs them
    (``python -m rustfhe_tpu_torch.benches.<name>``), each with the launch
    counts of its own run."""
    logp = functools.partial(log, "karatsuba")
    chained = _timing.STEPS * _timing.REPS + 1  # calls per timed line, the warm-up included
    counters = {"P4": karatsuba_probe.step_ablate, "P8": karatsuba_probe.step_var,
                "P1": karatsuba_probe.step_k2, "P2": karatsuba_probe.step_split,
                "K1": cmux_k.cmux_step}
    checks_p8 = len(vpu_reduce_probe.CHECKS) + 4  # the forms, then unroll2: 1 + 1 + 2 launches
    runs = {  # entry point -> the launches of its run
        "k2_floor_probe": (k2_floor_probe, {"P4": len(karatsuba_probe.ABLATIONS) * chained}),
        "vpu_reduce_probe": (vpu_reduce_probe, {
            "P8": checks_p8 + (len(vpu_reduce_probe.LINES) + 2 + 1) * chained, "K1": 1 + chained}),
        "karatsuba2_probe": (karatsuba2_probe, {"P1": 1 + 3 * chained, "K1": 1 + chained}),
        "coissue_probe": (coissue_probe, {"P2": 2 + 2 * chained, "P4": 1 + 2 * chained}),
    }
    launches = {}
    for name, (mod, want) in runs.items():
        karatsuba_probe.reset_counters()
        cmux_k.reset_counters()
        mod.run(out=logp)
        got = {k: c.launches for k, c in counters.items() if c.launches}
        if got != want:
            raise AssertionError(f"{name} launched {got}, expected {want}")
        launches[name] = got
    log("karatsuba", f"entry points at their defaults on {card}: launches {launches} "
        f"({chained} per timed line; unroll2 two per call)")
    return {"P4": launches["k2_floor_probe"]["P4"], "P8": launches["vpu_reduce_probe"]["P8"],
            "P1": launches["karatsuba2_probe"]["P1"], "P2": launches["coissue_probe"]["P2"]}


# --------------------------------------------------------------------- #
# 11. P3 (karatsuba_probe.step_coissue) and P10 (nuss_primitives)
# --------------------------------------------------------------------- #
NUSS_ROLLS = (0, 1, 17, 63)


def phase_coissue(dev, rs, card):
    """P3's two forms on a table from random rows: equal to the production
    step (P4 full) and to the "matmul" engine's acc + ExtProd(key,
    Decompose(X^a~ * acc - acc)) through the scan layout (their plain
    versions: phase 10); then A, B, C and K1 in turns at B=8192."""
    p = DEFAULT_PARAMS
    rows = words(rs, (2 * p.l, 2, p.N), dev)
    tab, key = karatsuba.prepare_table(rows), plain.prepare_trgsw(rows)
    std = words(rs, (PROBE_CHECK[-1], 2, p.N), dev)
    ai = torch.from_numpy(rs.randint(0, 2 * p.N, size=std.shape[0]).astype(np.int32)).to(dev)
    ai[:4] = torch.tensor([0, 1, p.N, 2 * p.N - 1], dtype=torch.int32)
    flat = karatsuba.scan_enter(std)
    m = get_engine("matmul")
    diff = poly.rotate(std, ai[:, None]) - std
    want = std + m.external_product_digits(m.prepare_trgsw(rows, p), decompose_trlwe(diff, p), p)
    full = karatsuba_probe.step_ablate(flat, ai, tab, p, "full")
    err = 0
    for pipelined in (False, True):
        got = karatsuba_probe.step_coissue(flat, ai, tab, p, pipelined)
        err = max(err, exact(f"P3 pipelined={pipelined} vs P4 full", got, full),
                  exact(f"P3 pipelined={pipelined} vs matmul", karatsuba.scan_exit(got), want))
    torch.cuda.synchronize()
    t = turns({"K1": lambda: cmux_k.cmux_step(std, ai, key, p),
               "A": lambda: karatsuba_probe.step_var(flat, ai, tab, p),
               "B": lambda: karatsuba_probe.step_coissue(flat, ai, tab, p, False),
               "C": lambda: karatsuba_probe.step_coissue(flat, ai, tab, p, True)}, 5)
    log("coissue", f"P3 B (per-leaf build) and C (pipelined) equal P4 full and the matmul "
        f"engine's step through the scan layout at B={std.shape[0]}; on {card}, ms/step in "
        f"turns: A (upfront, P8 leaf_u32) {t['A']:.4f}, B {t['B']:.4f}, C {t['C']:.4f}, K1 "
        f"{t['K1']:.4f}; B/A {t['B'] / t['A']:.4f}, C/A {t['C'] / t['A']:.4f}")
    return err, t


def phase_nuss_primitives(dev, card):
    """P10 against its plain version and the host reference at every roll
    of NUSS_ROLLS, on the probe's (128, 2048) tile, on 13 rows (a ragged
    count) and at the transform's size (24576, 2048); then its device time
    (profiler) beside ``out.copy_(x)``'s on the same tensors at the probe's
    tile and the transform's size, and the kernel and plain version in
    turns by CUDA events.  Returns the largest error and (kernel ms, plain
    ms, bytes) at the transform's size."""
    probe = nussbaumer_primitives_probe
    err = 0
    for rows in (probe.TB, 13, probe.TRANSFORM_ROWS):
        x0 = probe.draw(rows)
        x = _u32.from_numpy(x0, dev)
        for s in NUSS_ROLLS:
            got = nuss_primitives.nuss_primitives(x, s)
            err = max(err, exact(f"P10 {tuple(x.shape)} S={s} vs plain", got,
                                 nuss_primitives.nuss_primitives_plain(x, s)))
            host = probe.butterfly_host(probe.block_neg_roll_host(x0, s))
            exact(f"P10 {tuple(x.shape)} S={s} vs host", got, _u32.from_numpy(host))
    times = {}
    for rows, width in probe.SHAPES:
        x = _u32.from_numpy(probe.draw(rows), dev)
        y = torch.empty_like(x)
        big = rows > probe.TB
        ev = turns({"plain": lambda: nuss_primitives.nuss_primitives_plain(x, nuss_primitives.ROLL),
                    "kernel": lambda: nuss_primitives.nuss_primitives(x, nuss_primitives.ROLL)},
                   20 if big else 200)
        # Back to back at 2 MiB, a call's event time is the host's issue time
        # (the wrapper's checks and ctypes): the device time comes from the
        # profiler.  The plain version's launches at 402.7 MB outlast their
        # issue, so there its event time is its device time.
        k_ms = probe.device_ms(lambda: nuss_primitives.nuss_primitives(x, nuss_primitives.ROLL))[0]
        c_ms = probe.device_ms(lambda: y.copy_(x))[0]
        nbytes = x.numel() * 4 * 2
        b_ms = bound(0.0, nbytes)[0]
        times[rows] = (k_ms, ev["plain"], nbytes)
        log("nuss", f"P10 {tuple(x.shape)}, S={nuss_primitives.ROLL}, on {card}, us per call: "
            f"device time (profiler) kernel {k_ms * 1e3:.2f}, out.copy_(x) {c_ms * 1e3:.2f}; "
            f"bound {b_ms * 1e3:.2f} ({nbytes / 1e6:.1f} MB at 3.35 TB/s): the kernel at "
            f"{b_ms / k_ms:.1%}, the copy at {b_ms / c_ms:.1%}; CUDA events in turns kernel "
            f"{ev['kernel'] * 1e3:.2f}, plain {ev['plain'] * 1e3:.2f}"
            + ("" if big else " (the host's issue time)"))
        del x, y
    log("nuss", f"P10 bit-exact against its plain version and the host reference at S="
        f"{', '.join(map(str, NUSS_ROLLS))} on ({probe.TB}, {probe.W}), (13, {probe.W}) and "
        f"({probe.TRANSFORM_ROWS}, {probe.W})")
    return err, times[probe.TRANSFORM_ROWS]


PROFILE_TRIES = 3  # now and then a profiler session records no launch, or only some


def profiled_times(fn, calls: int, seen=lambda times, counts: sum(times.values()) > 0):
    """(device time in ms, launches) of each kernel the profiler saw on the
    card in ``calls`` calls of ``fn``, after a warm-up.  A session whose
    times and counts fail ``seen`` (by default: no device time at all) is
    run again, up to PROFILE_TRIES sessions, and then it raises."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts = {}
        times = device_times(prof, counts)
        if seen(times, counts):
            return times, counts
    raise AssertionError(f"in {PROFILE_TRIES} sessions the profiler saw no device time of the "
                         f"kernels it was to time ({sorted(times)})")


def kernel_label(key: str) -> str:
    """A profiler key's kernel name and template arguments, without the
    namespaces and the parameter list."""
    name = re.sub(r"\(anonymous namespace\)::|rustfhe::cmux::|rustfhe::", "", key)
    return name.split("(")[0].replace("void ", "").strip()


def profiled_ms(fn, calls: int) -> float:
    """Device time (ms) per call of ``fn``: the sum over every kernel the
    profiler saw on the card in ``calls`` calls, after a warm-up."""
    return sum(profiled_times(fn, calls)[0].values()) / calls


def phase_coissue_entry_points(card):
    """coissue2_probe and nussbaumer_primitives_probe at their defaults, as
    a user runs them, each with the launch counts of its own run."""
    chained = _timing.STEPS * _timing.REPS + 1
    karatsuba_probe.reset_counters()
    int8_gemm.reset_counters()
    coissue2_probe.run(out=functools.partial(log, "coissue"))
    got = {"P3": karatsuba_probe.step_coissue.launches, "P8": karatsuba_probe.step_var.launches,
           "int8_gemm": int8_gemm.int8_matmul.launches}
    want = {"P3": 2 + 2 * chained, "P8": chained, "int8_gemm": 1}
    if got != want:
        raise AssertionError(f"coissue2_probe launched {got}, expected {want}")
    nuss_primitives.reset_counters()
    res = nussbaumer_primitives_probe.run(out=functools.partial(log, "nuss"))
    p10 = nuss_primitives.nuss_primitives.launches
    if p10 != res["launches"]:
        raise AssertionError(f"nussbaumer_primitives_probe launched P10 {p10} times in "
                             f"{res['launches']} calls")
    log("coissue", f"entry points at their defaults on {card}: coissue2_probe {got}, "
        f"nussbaumer_primitives_probe P10 {p10}")
    return got["P3"], p10


# --------------------------------------------------------------------- #
# 12. The generic-engine path: "matmul", "matmul_bf16", "nuss", "fft64"
# --------------------------------------------------------------------- #
P_BG9 = TFHEParams(bgbit=9, l=2, n=64)  # Bg = 2^9: digits to 256, past int8


def phase_matmul_path(dev, card, mixed_pre, mixed_out, mixed_want, k1_key):
    """DEFAULT_PARAMS through ``TFHE.new(..., engine_name="matmul")`` on
    phase 4's seed (the same raw keys): phase 4's mixed batch word for word,
    a timed NAND batch, one int8 GEMM launch per step and no K1.  Then the
    step's parts beside K1's step on the same key (``k1_key``, phase 4's
    prepared first step)."""
    p = DEFAULT_PARAMS
    cmux_k.reset_counters()
    int8_gemm.reset_counters()
    t0 = time.perf_counter()
    ctx = TFHE.new(SEED, p, device=dev, engine_name="matmul")
    torch.cuda.synchronize()
    t_keys = time.perf_counter() - t0
    probe = int8_gemm.int8_matmul.launches
    if not isinstance(ctx.ck.bk, GenericBK) or probe != 1:
        raise AssertionError(f"matmul context: key {type(ctx.ck.bk).__name__}, probe {probe}")
    gemm = int8_gemm.int8_matmul
    out = one_pass(lambda: ctx.bootstrap_raw(mixed_pre), p, gemm)
    check_bits("matmul mixed batch", ctx.decrypt(out).cpu().numpy(), mixed_want)
    exact("matmul mixed batch vs K1", out, mixed_out)
    pat = np.tile(np.array([[0, 0], [1, 0], [0, 1], [1, 1]]), (BATCH // 4 + 1, 1))[:BATCH]
    cx, cy = ctx.encrypt(pat[:, 0]), ctx.encrypt(pat[:, 1])
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        nand = one_pass(lambda: ctx.nand(cx, cy), p, gemm)
        if i:
            times.append(time.perf_counter() - t0)
    check_bits("matmul NAND", ctx.decrypt(nand).cpu().numpy(), 1 - (pat[:, 0] & pat[:, 1]))
    # One more pass under the profiler: the device's busy and idle share.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one_pass(lambda: ctx.nand(cx, cy), p, gemm)
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms = device_times(prof)
    busy = sum(dev_ms.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time in the matmul pass")
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:4]
    log("profile", f"matmul NAND pass, B={BATCH}, on {card}: device busy {busy:.1f} ms of "
        f"{wall:.1f} ms wall, idle share {1 - busy / wall:.4f}; top kernels: "
        + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top))
    passes = 5
    launches = {"int8_gemm": gemm.launches, "k1": cmux_k.cmux_step.launches}
    if launches != {"int8_gemm": probe + passes * p.n, "k1": 0}:
        raise AssertionError(f"matmul path launches {launches}, expected int8_gemm = {probe} + "
                             f"{passes} x {p.n} and no K1")
    best = min(times)
    log("matmul", f"DEFAULT_PARAMS, engine matmul, on {card}: keys in {t_keys:.2f} s; the mixed "
        f"batch of {MIXED} decrypts correctly and equals phase 4's K1 output word for word; "
        f"NAND B={BATCH}: {BATCH}/{BATCH} correct, {best * 1e3:.1f} ms per batch -> "
        f"{BATCH / best:.1f} gates/s ({best / p.n * 1e3:.3f} ms/step); launches {launches} "
        f"({probe} probe + {passes} passes x {p.n})")

    # The step's parts at B=4096 on the real key: the circulant, the GEMM
    # (against torch._int_mm on the same operands), the external product, the step.
    m = get_engine("matmul")
    acc, a_steps = bootstrap.rotation_start(gates.precombine("nand", cx, cy, params=p),
                                            trlwe.trivial(torch.full((p.N,), p.mu, dtype=torch.int32,
                                                                     device=dev)), p)
    table = ctx.ck.bk.table[0]
    digits = decompose_trlwe(poly.rotate(acc, a_steps[0][:, None]) - acc, p)
    wt = matmul.circulant(table)
    d = digits.flip(-1).reshape(BATCH, -1).to(torch.int8)
    exact("int8 GEMM vs torch._int_mm", int8_gemm.int8_matmul(d, wt),
          torch._int_mm(d, wt.t()))

    def step():
        diff = poly.rotate(acc, a_steps[0][:, None]) - acc
        return acc + m.external_product_digits(table, decompose_trlwe(diff, p), p)

    def k1_step():
        return cmux_k.cmux_step(acc, a_steps[0], k1_key, p)

    exact("K1 step vs the matmul step on the same raw key", k1_step(), step())
    t = turns({"torch._int_mm": lambda: torch._int_mm(d, wt.t()),
               "int8_gemm": lambda: int8_gemm.int8_matmul(d, wt),
               "circulant": lambda: matmul.circulant(table),
               "external product": lambda: m.external_product_digits(table, digits, p),
               "step": step, "K1 step": k1_step}, 10)
    M, K = d.shape
    ops = 2 * M * K * wt.shape[0]
    log("matmul", f"step parts at B={BATCH} on {card}, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items()) + f"; GEMM {M} x {K} x {wt.shape[0]}: int8_gemm "
        f"(tile {int8_gemm.TILE}) {ops / t['int8_gemm'] / 1e9:.1f} TOPS, torch._int_mm "
        f"{ops / t['torch._int_mm'] / 1e9:.1f}; K1's step equals the matmul step word for word, "
        f"matmul step / K1 step {t['step'] / t['K1 step']:.3f}")
    return BATCH / best, t, launches


def phase_generic_engines(dev, card):
    """matmul_bf16, nuss and fft64 admitted by the oracle probe on the card
    at DEFAULT_PARAMS, each external product equal to matmul's on a random
    B=256 batch; then a mixed batch at Bg = 2^9 on matmul_bf16."""
    p = DEFAULT_PARAMS
    rs = np.random.RandomState(SEED + 12)
    rows = words(rs, (2 * p.l, 2, p.N), dev)
    digits = torch.from_numpy(rs.randint(-p.half_bg, p.half_bg, size=(256, 2 * p.l, p.N))
                              .astype(np.int32)).to(dev)
    m = get_engine("matmul")
    want = m.external_product_digits(m.prepare_trgsw(rows, p), digits, p)
    secs = {}
    for name in ("matmul_bf16", "nuss", "fft64"):
        t0 = time.perf_counter()
        if select_engine(p, dev, name) != name:
            raise AssertionError(f"{name} not admitted")
        eng = get_engine(name)
        exact(f"{name} vs matmul, B=256", eng.external_product_digits(eng.prepare_trgsw(rows, p),
                                                                      digits, p), want)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    setting = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:  # matmul_bf16 must not depend on cuBLAS's bf16 reduction flag
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
            select_engine(p, dev, "matmul_bf16")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = setting
    log("engines", f"DEFAULT_PARAMS on {card}: matmul_bf16, nuss and fft64 admitted by the oracle "
        "probe on the card, each external product equal to matmul's on B=256 (probe and check, s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + "); matmul_bf16 exact with allow_bf16_reduced_precision_reduction on and off")

    pb = P_BG9
    t0 = time.perf_counter()
    ctx = TFHE.new(SEED, pb, device=dev)
    if ctx.engine_name != "matmul_bf16":
        raise AssertionError(f"Bg = 2^9 picked {ctx.engine_name}")
    _, pre, _, want_bits = mixed_batch(ctx, pb)
    out = ctx.bootstrap_raw(pre)
    check_bits("Bg=2^9 mixed batch", ctx.decrypt(out).cpu().numpy(), want_bits)
    torch.cuda.synchronize()
    log("engines", f"TFHEParams(bgbit=9, l=2, n={pb.n}) on {card}: engine matmul_bf16 by the rule; "
        f"keys and a mixed batch of {MIXED} in {time.perf_counter() - t0:.2f} s, every output "
        "decrypts correctly")


# --------------------------------------------------------------------- #
# 13. The encrypted-integer path: evaluate_encrypted, FheUint / FheInt,
#     K3 against K1, and the port bench
# --------------------------------------------------------------------- #
INT_PAIRS = 256  # pairs for the ops of few levels (8-bit add: 84 lanes a pair)
MUL_PAIRS = 64   # the 8-bit Wallace multiply: 30 levels, 584 lanes a pair
WIDE_PAIRS = 16  # FheInt.mul_full, a 16-bit Wallace multiply: 56 levels, 2360 lanes a pair
DIV_PAIRS = 8    # divmod: 72 levels, 864 lanes a pair
ADD32_PAIRS = 64  # the 32-bit Kogge-Stone add: 11 levels, 560 lanes a pair
BENCH_CHILD = {"BENCH_BATCH": "4096", "BENCH_ITERS": "2"}


class Bootstraps:
    """Counts a context's bootstrap_raw calls (levels) and lanes (the
    flattened batches, padding counted) while it is installed."""

    def __init__(self, ctx):
        self.ctx, self.calls, self.lanes = ctx, 0, 0
        raw = ctx.bootstrap_raw

        def counted(pre):
            self.calls += 1
            self.lanes += pre.shape[:-1].numel()
            return raw(pre)

        ctx.bootstrap_raw = counted

    def remove(self):
        del self.ctx.bootstrap_raw


def int_op(name, fn, counter, rows, card, want=None, got_fn=None):
    """Run one integer op, timed (host clock around synchronised work);
    check its decryption against numpy; log ms, levels, lanes and
    bootstraps/s.  Returns the op's output."""
    calls, lanes = counter.calls, counter.lanes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    calls, lanes = counter.calls - calls, counter.lanes - lanes
    if want is not None:
        got = got_fn(out)
        if not np.array_equal(got, want):
            bad = int((np.asarray(got) != np.asarray(want)).sum())
            raise AssertionError(f"integers: {name}: {bad}/{np.size(want)} values decrypt wrong")
    rows.append((name, ms, calls, lanes))
    log("integers", f"{name}: {ms:.1f} ms, {calls} levels, {lanes} bootstrap lanes (padding "
        f"counted), {lanes / ms * 1e3 if calls else 0:.1f} bootstraps/s on {card}")
    return out


def latency_levels(p, dev, widths, pairs) -> str:
    """K3's cluster size and waves for each level batch (width x pairs)."""
    parts = []
    for w in widths:
        b = w * pairs
        cluster = rotate_all_k.cluster_for(b, p, dev)
        held = rotate_all_k.max_clusters(p, cluster)
        parts.append(f"B={b}: clusters of {cluster}, {-(-b // held)} wave(s) of {held}")
    return "; ".join(parts)


def phase_integers(ctx, p, dev, card):
    """The encrypted-integer path at DEFAULT_PARAMS on phase 4's context:
    the bench's adder check, FheUint / FheInt ops on seeded operands, each
    decrypted against numpy, with K1 launched 635 times per bootstrap
    call; then a latency context on the same keys runs an 8-bit add and a
    compare on K3 at batch 1 and 2, word for word equal to the K1 context,
    one K3 launch per level and no K1; then the port bench as a subprocess."""
    from rustfhe_tpu_torch import FheInt, FheUint, keys
    from rustfhe_tpu_torch import bench as port_bench
    from rustfhe_tpu_torch.apps import circuits

    rs = np.random.RandomState(SEED + 13)
    draw = (lambda n, bits: rs.randint(0, 1 << bits, n, dtype=np.uint64))
    cmux_k.reset_counters()
    rotate_all_k.rotate_all.launches = 0
    counter = Bootstraps(ctx)
    rows = []
    try:
        t_adder = port_bench.check_adder(ctx)
        log("integers", f"the bench's adder check: 4 sums of the 8-bit ripple-carry adder at "
            f"fixed width 16 ({circuits.ripple_carry_adder(8).depth} levels) right, "
            f"{t_adder * 1e3:.1f} ms on {card}")
        av, bv = draw(INT_PAIRS, 8), draw(INT_PAIRS, 8)
        a, b = ctx.encrypt_uint(av, 8), ctx.encrypt_uint(bv, 8)
        u8 = (lambda x: x.decrypt())
        bit = (lambda ct: ctx.decrypt(ct).cpu().numpy())
        m = np.uint64(255)
        int_op("uint8 +", lambda: a + b, counter, rows, card, (av + bv) & m, u8)
        int_op("uint8 -", lambda: a - b, counter, rows, card, (av - bv) & m, u8)
        int_op("uint8 &", lambda: a & b, counter, rows, card, av & bv, u8)
        int_op("uint8 |", lambda: a | b, counter, rows, card, av | bv, u8)
        int_op("uint8 ^", lambda: a ^ b, counter, rows, card, av ^ bv, u8)
        int_op("uint8 ~", lambda: ~a, counter, rows, card, ~av & m, u8)
        int_op("uint8 << 3", lambda: a << 3, counter, rows, card, (av << np.uint64(3)) & m, u8)
        int_op("uint8 >> 3", lambda: a >> 3, counter, rows, card, av >> np.uint64(3), u8)
        lt = int_op("uint8 lt", lambda: a.lt(b), counter, rows, card, av < bv, bit)
        int_op("uint8 eq", lambda: a.eq(b), counter, rows, card, av == bv, bit)
        int_op("uint8 gt", lambda: a.gt(b), counter, rows, card, av > bv, bit)
        int_op("uint8 min_", lambda: a.min_(b), counter, rows, card, np.minimum(av, bv), u8)
        int_op("uint8 max_", lambda: a.max_(b), counter, rows, card, np.maximum(av, bv), u8)
        int_op("uint8 select", lambda: a.select(lt, b), counter, rows, card,
               np.where(av < bv, av, bv), u8)
        ma, mb = FheUint(ctx, a.bits[:MUL_PAIRS]), FheUint(ctx, b.bits[:MUL_PAIRS])
        int_op(f"uint8 * ({MUL_PAIRS} pairs)", lambda: ma * mb, counter, rows, card,
               (av[:MUL_PAIRS] * bv[:MUL_PAIRS]) & m, u8)
        sv, tv = av.astype(np.int64) - 128, bv.astype(np.int64) - 128
        sa, sb = ctx.encrypt_sint(sv, 8), ctx.encrypt_sint(tv, 8)
        int_op("int8 lt", lambda: sa.lt(sb), counter, rows, card, sv < tv, bit)
        int_op("int8 eq", lambda: sa.eq(sb), counter, rows, card, sv == tv, bit)
        int_op("int8 gt", lambda: sa.gt(sb), counter, rows, card, sv > tv, bit)
        int_op("int8 abs_", lambda: sa.abs_(), counter, rows, card,
               np.where(sv == -128, -128, np.abs(sv)), u8)
        wa, wb = FheInt(ctx, sa.bits[:WIDE_PAIRS]), FheInt(ctx, sb.bits[:WIDE_PAIRS])
        int_op(f"int8 mul_full ({WIDE_PAIRS} pairs)", lambda: wa.mul_full(wb), counter, rows,
               card, sv[:WIDE_PAIRS] * tv[:WIDE_PAIRS], u8)
        dv = draw(DIV_PAIRS, 8)
        dv[:2] = [0, 1]  # a zero divisor (q = 255, r = a) and a divisor of one
        da = FheUint(ctx, a.bits[:DIV_PAIRS])
        db = ctx.encrypt_uint(dv, 8)
        safe = np.where(dv == 0, 1, dv)
        q_want = np.where(dv == 0, 255, av[:DIV_PAIRS] // safe)
        r_want = np.where(dv == 0, av[:DIV_PAIRS], av[:DIV_PAIRS] % safe)
        int_op(f"uint8 divmod ({DIV_PAIRS} pairs, one zero divisor)", lambda: da.divmod(db),
               counter, rows, card, np.stack([q_want, r_want]),
               lambda qr: np.stack([qr[0].decrypt(), qr[1].decrypt()]))
        xv, yv = draw(ADD32_PAIRS, 32), draw(ADD32_PAIRS, 32)
        x32, y32 = ctx.encrypt_uint(xv, 32), ctx.encrypt_uint(yv, 32)
        int_op(f"uint32 + Kogge-Stone ({ADD32_PAIRS} pairs)", lambda: x32 + y32, counter, rows,
               card, (xv + yv) & np.uint64(2**32 - 1), u8)
        k1_calls = counter.calls
        k1 = cmux_k.cmux_step.launches
        if k1 != p.n * k1_calls or rotate_all_k.rotate_all.launches:
            raise AssertionError(f"integers: K1 launched {k1} times for {k1_calls} bootstrap "
                                 f"calls (expected {p.n} each), K3 "
                                 f"{rotate_all_k.rotate_all.launches}")
        total_ms = sum(r[1] for r in rows)
        lanes = sum(r[3] for r in rows)
        log("integers", f"K1 launched {k1} times = {p.n} x {k1_calls} bootstrap calls (the "
            f"adder check and {len(rows)} ops), no K3; the ops' {lanes} lanes in "
            f"{total_ms:.1f} ms -> {lanes / total_ms * 1e3:.1f} bootstraps/s on {card}")
    finally:
        counter.remove()

    # The latency context on the same keys: K3 at batch 1 and 2, word for
    # word against the K1 loop of phase 4's context.
    lat = TFHE(ctx.sk, keys.cloud_key_latency(ctx.ck), p, dev, None, ctx.engine_name)
    la, lb = ctx.encrypt_uint(av[:2], 8), ctx.encrypt_uint(bv[:2], 8)
    on_k1, on_k3 = Bootstraps(ctx), Bootstraps(lat)
    k1_before = cmux_k.cmux_step.launches
    rotate_all_k.rotate_all.launches = 0
    times = {"K3": [], "K1 loop": []}
    try:
        for pairs in (1, 2):
            for op, fn in (("+", lambda x, y: (x + y).bits), ("lt", lambda x, y: x.lt(y))):
                outs = {}
                for mode, c in (("K3", lat), ("K1 loop", ctx)):
                    x, y = FheUint(c, la.bits[:pairs]), FheUint(c, lb.bits[:pairs])
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    outs[mode] = fn(x, y)
                    torch.cuda.synchronize()
                    if op == "+" and pairs == 1:
                        times[mode].append((time.perf_counter() - t0) * 1e3)
                if not torch.equal(outs["K3"], outs["K1 loop"]):
                    raise AssertionError(f"integers: K3's 8-bit {op} at batch {pairs} differs "
                                         "from the K1 loop's")
        # Two more single adds each, in turns, for the times.
        x1, y1 = la.bits[:1], lb.bits[:1]
        for _ in range(2):
            for mode, c in (("K3", lat), ("K1 loop", ctx)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                FheUint(c, x1) + FheUint(c, y1)
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) * 1e3)
        k3 = rotate_all_k.rotate_all.launches
        k1 = cmux_k.cmux_step.launches - k1_before
        if k3 != on_k3.calls or k1 != p.n * on_k1.calls:
            raise AssertionError(f"integers: latency part launched K3 {k3} times for "
                                 f"{on_k3.calls} bootstrap calls, K1 {k1} for {on_k1.calls}")
    finally:
        on_k1.remove()
        on_k3.remove()
    widths = [16, 16, 16, 16, 8, 8, 4]  # the 8-bit Kogge-Stone add's bucketed levels
    log("integers", f"latency context on the same keys: 8-bit + and lt at batch 1 and 2 equal "
        f"the K1 loop's word for word; K3 launched {k3} times = its {on_k3.calls} bootstrap "
        f"calls, no K1 in the latency context; a single 8-bit add: K3 "
        + ", ".join(f"{t:.2f}" for t in times["K3"]) + " ms, K1 loop "
        + ", ".join(f"{t:.2f}" for t in times["K1 loop"]) + f" ms on {card}; K3's levels "
        f"at batch 1: {latency_levels(p, dev, widths, 1)}")

    # The port bench, as a user runs it.
    env = {k: v for k, v in os.environ.items()
           if k not in ("RUSTFHE_FORCE_CPU", "BENCH_PARAMS", "BENCH_GATES", "BENCH_HYBRID",
                        "BENCH_SHARDED")}
    env.update(BENCH_CHILD)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "rustfhe_tpu_torch.bench"], capture_output=True,
                       text=True, timeout=600, env=env,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    out = r.stdout.strip().splitlines()
    if r.returncode != 0 or len(out) != 1:
        raise AssertionError(f"integers: the bench exited {r.returncode} with stdout {out}; "
                             f"stderr: {r.stderr[-2000:]}")
    rec = json.loads(out[0])
    if (rec.get("metric") != port_bench.METRIC or rec.get("unit") != "gates/s"
            or not rec.get("value", 0) > 0):
        raise AssertionError(f"integers: the bench printed {out[0]}")
    checks = [ln for ln in r.stderr.splitlines() if ln.startswith(("# correctness", "# per-batch"))]
    log("integers", f"python3 -m rustfhe_tpu_torch.bench ("
        + ", ".join(f"{k}={v}" for k, v in BENCH_CHILD.items()) + ") in "
        f"{time.perf_counter() - t0:.1f} s: {out[0]}; {len(checks) - 1} checks passed; "
        + (checks[-1][2:] if checks else "no per-batch line"))
    return rows, times, rec


# --------------------------------------------------------------------- #
# 14. Programmable bootstrapping and the radix integers at PBS_PARAMS
# --------------------------------------------------------------------- #
PBS_LOOKUPS = 16384  # the chained space-8 batch: radix_bench's PBS_BATCH of 65536, cut to 1/4
RADIX_LANES = 256    # radix_bench's BATCH
RADIX_DIGITS = 4     # 8-bit radix integers
PBS_SPACE = 8


class Rotations:
    """Counts the blind rotations and their rows (lookups) while installed,
    at ``bootstrap.rotation_start``, which every blind rotation calls once
    with its rows flattened."""

    def __init__(self):
        self.orig = bootstrap.rotation_start
        self.calls = self.rows = 0

        def counted(ct, testvec, params):
            self.calls += 1
            self.rows += ct.shape[0]
            return self.orig(ct, testvec, params)

        bootstrap.rotation_start = counted

    def remove(self):
        bootstrap.rotation_start = self.orig


def power_clock_text(rows) -> str:
    """The power draw (W) and SM clock (MHz) samples of ``stop_sampling``."""
    if not rows:
        return "power and SM clock not measured"
    w, mhz = np.array(rows).T
    return (f"power {w.min():.1f}-{w.max():.1f} W (mean {w.mean():.1f}), SM clock "
            f"{mhz.min():.0f}-{mhz.max():.0f} MHz (mean {mhz.mean():.0f}) over {len(rows)} "
            "nvidia-smi samples")


def radix_op(name, fn, rot, rows, card, want, got_fn):
    """Run one PBS-path op, timed (host clock around synchronised work);
    check its decryption against numpy; log ms, bootstrap levels (from the
    launch counts: n K1 launches or one K3 launch a level, checked against
    the blind rotations ``rot`` saw) and lookups (the levels' rows).
    Returns the op's output."""
    n = PBS_PARAMS.n
    k1, k3, calls, lookups = (cmux_k.cmux_step.launches, rotate_all_k.rotate_all.launches,
                              rot.calls, rot.rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    k1, k3 = cmux_k.cmux_step.launches - k1, rotate_all_k.rotate_all.launches - k3
    calls, lookups = rot.calls - calls, rot.rows - lookups
    levels = k1 // n + k3
    if k1 % n or levels != calls:
        raise AssertionError(f"pbs: {name}: K1 launched {k1} times and K3 {k3} for {calls} "
                             f"blind rotations (expected {n} K1 launches or one K3 each)")
    got = got_fn(out)
    if not np.array_equal(got, want):
        bad = int((np.asarray(got) != np.asarray(want)).sum())
        raise AssertionError(f"pbs: {name}: {bad}/{np.size(want)} values decrypt wrong")
    rows.append((name, ms, levels, lookups))
    log("pbs", f"{name}: {ms:.1f} ms, {levels} bootstrap levels, {lookups} lookups, "
        f"{lookups / ms * 1e3:.1f} lookups/s on {card}; every value right")
    return out


def phase_pbs(dev, card):
    """The PBS and radix path at PBS_PARAMS (n=714, N=2048, l=4, Bg=2^6,
    key switch 4x4) on a context of ``TFHE.new(SEED, PBS_PARAMS)``: the
    space-8 chained lookups at B=PBS_LOOKUPS with a table per row, the
    t=2 multi-lookup at 256 lanes, the port radix_bench's ops at 256
    lanes, ``from_pbs_int``, and a radix add at batch 1 on K3 against the
    K1 loop.  Returns (the context, the latency context, K1's and K3's
    launches, and the B=PBS_LOOKUPS batch's pre-offset inputs and tables
    for the real-key check)."""
    p = PBS_PARAMS
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = TFHE.new(SEED, p, device=dev)
    torch.cuda.synchronize()
    if ctx.engine_name != "cmux_k":
        raise AssertionError(f"pbs: TFHE.new picked {ctx.engine_name} at PBS_PARAMS, not cmux_k")
    log("pbs", f"TFHE.new(SEED, PBS_PARAMS) on {dev}: engine {ctx.engine_name} by the rule, "
        f"keys in {time.perf_counter() - t0:.2f} s; {pbs.check_pbs_space(p, PBS_SPACE)[1]}; "
        f"{radix.check_radix(p)[1]}")
    rs = np.random.RandomState(SEED + 14)
    cmux_k.reset_counters()
    rotate_all_k.rotate_all.launches = 0
    rot = Rotations()
    rows = []
    try:
        # The space-8 lookups, a table per row, chained twice.
        B = PBS_LOOKUPS
        xs = rs.randint(0, PBS_SPACE, size=B)
        tables = rs.randint(0, PBS_SPACE, size=(B, PBS_SPACE))
        ct = ctx.encrypt_int(xs, PBS_SPACE)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        clock = sample_card("power.draw,clocks.sm")
        try:
            mid = radix_op(f"space-8 lookup, a table per row, B={B}",
                           lambda: ctx.apply_lut(ct, tables, PBS_SPACE), rot, rows, card,
                           tables[np.arange(B), xs],
                           lambda o: ctx.decrypt_int(o, PBS_SPACE).cpu().numpy())
            radix_op(f"the same lookups chained, B={B}",
                     lambda: ctx.apply_lut(mid, tables, PBS_SPACE), rot, rows, card,
                     tables[np.arange(B), tables[np.arange(B), xs]],
                     lambda o: ctx.decrypt_int(o, PBS_SPACE).cpu().numpy())
        finally:
            power = power_clock_text(stop_sampling(clock))
        peak = torch.cuda.max_memory_allocated(dev)
        log("pbs", f"B={B} (cut from radix_bench's PBS_BATCH of 65536 to keep the phase near a "
            f"minute): {B}/{B} chained lookups decode right; {power}; allocator peak "
            f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the keys and inputs) "
            f"on {card}")
        del mid

        # The multi-lookup (t=2) at the radix batch, its decode errors counted.
        ok_m, msg_m = pbs.check_pbs_many(p, PBS_SPACE, 2)
        tabs2 = rs.randint(0, PBS_SPACE, size=(2, PBS_SPACE))
        ctm = ctx.encrypt_int(xs[:RADIX_LANES], PBS_SPACE)
        calls = rot.calls
        outm = ctx.apply_luts(ctm, tabs2, PBS_SPACE)
        decm = ctx.decrypt_int(outm, PBS_SPACE).cpu().numpy()
        bad = sum(int((decm[:, j] != tabs2[j][xs[:RADIX_LANES]]).sum()) for j in range(2))
        if rot.calls - calls != 1 or not ok_m:
            raise AssertionError(f"pbs: apply_luts ran {rot.calls - calls} rotations ({msg_m})")
        log("pbs", f"apply_luts (space 8, t=2) at {RADIX_LANES} lanes: one rotation, "
            f"{2 * RADIX_LANES - bad}/{2 * RADIX_LANES} lookups decode right ({bad} errors; "
            f"{msg_m})")

        # The port radix_bench's ops at RADIX_LANES lanes, 8 bits.
        nd, m8 = RADIX_DIGITS, radix_bench.M8
        av = rs.randint(0, 256, size=RADIX_LANES).astype(np.uint64)
        bv = rs.randint(0, 256, size=RADIX_LANES).astype(np.uint64)
        v = SimpleNamespace(a=av, b=bv, sa=av.astype(np.int64) - 128, sb=bv.astype(np.int64) - 128)
        o = SimpleNamespace(a=ctx.encrypt_radix(v.a, nd), b=ctx.encrypt_radix(v.b, nd),
                            ua=ctx.encrypt_uint(v.a, 8), ub=ctx.encrypt_uint(v.b, 8),
                            sa=ctx.encrypt_radix_signed(v.sa, nd),
                            sb=ctx.encrypt_radix_signed(v.sb, nd))
        for name, (op, want) in radix_bench.OPS.items():
            radix_op(name, lambda: op(o), rot, rows, card, want(v),
                     lambda out: radix_bench.decrypt(ctx, out))
        u = radix_op(f"from_pbs_int at space 8, {RADIX_LANES} lanes",
                     lambda: ctx.int_to_uint(ctm, PBS_SPACE), rot, rows, card,
                     xs[:RADIX_LANES].astype(np.uint64), lambda r: r.decrypt())
        t_chosen = next((t for t in (4, 2) if pbs.check_pbs_many(p, PBS_SPACE, t)[0]), 1)
        log("pbs", f"from_pbs_int: {u.width} bit planes in {rows[-1][2]} rotations of t="
            f"{t_chosen} (t=4: {pbs.check_pbs_many(p, PBS_SPACE, 4)[1]})")
        k1_std = rot.calls
        if cmux_k.cmux_step.launches != p.n * k1_std or rotate_all_k.rotate_all.launches:
            raise AssertionError(f"pbs: K1 launched {cmux_k.cmux_step.launches} times for "
                                 f"{k1_std} bootstrap calls (expected {p.n} each), K3 "
                                 f"{rotate_all_k.rotate_all.launches}")

        # A latency context from the same seed: a radix 8-bit add at batch 1
        # on K3, word for word the K1 loop's.
        lat = TFHE.new(SEED, p, device=dev, latency_mode=True)
        if not torch.equal(lat.ck.bk.bk, ctx.ck.bk):
            raise AssertionError("pbs: the latency context's key differs from the same seed's")
        la, lb = ctx.encrypt_radix(av[:1], nd), ctx.encrypt_radix(bv[:1], nd)
        k1_before = cmux_k.cmux_step.launches
        times = {"K3": [], "K1 loop": []}
        calls = {"K3": 0, "K1 loop": 0}
        outs = {}
        for _ in range(3):
            for mode, c in (("K3", lat), ("K1 loop", ctx)):
                x, y = radix.RadixUint(c, la.digits), radix.RadixUint(c, lb.digits)
                before = rot.calls
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[mode] = (x + y).digits
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) * 1e3)
                calls[mode] += rot.calls - before
            if not torch.equal(outs["K3"], outs["K1 loop"]):
                raise AssertionError("pbs: K3's radix add at batch 1 differs from the K1 loop's")
        np.testing.assert_array_equal(radix.RadixUint(ctx, outs["K3"]).decrypt(),
                                      (av[:1] + bv[:1]) & m8)
        k3_lat = rotate_all_k.rotate_all.launches
        if (k3_lat != calls["K3"] or k3_lat != 3 * nd
                or cmux_k.cmux_step.launches - k1_before != p.n * calls["K1 loop"]):
            raise AssertionError(f"pbs: the latency part launched K3 {k3_lat} times for "
                                 f"{calls['K3']} latency calls, K1 "
                                 f"{cmux_k.cmux_step.launches - k1_before} for "
                                 f"{calls['K1 loop']} calls on the standard key")
        log("pbs", f"latency context (TFHE.new(SEED, PBS_PARAMS, latency_mode=True), the same "
            f"key): a radix 8-bit add at batch 1 equals the K1 loop's word for word, 3 times; "
            f"{k3_lat} K3 launches for its {calls['K3']} levels ({calls['K1 loop']} "
            f"K1-loop levels on the standard key); K3 " + ", ".join(
                f"{t:.2f}" for t in times["K3"]) + " ms, K1 loop " + ", ".join(
                f"{t:.2f}" for t in times["K1 loop"]) + f" ms on {card}; K3's clusters at "
            f"B=2: {rotate_all_k.cluster_for(2, p, dev)} blocks")
        k1_total, k1_calls = cmux_k.cmux_step.launches, k1_std + calls["K1 loop"]
        kara_total = cmux_k.cmux_step_karatsuba.launches  # among k1_total
        if k1_total != p.n * k1_calls:
            raise AssertionError(f"pbs: K1 launched {k1_total} times for {k1_calls} K1-loop calls")
        total_ms = sum(r[1] for r in rows)
        log("pbs", f"K1 launched {k1_total} times = {p.n} x {k1_calls} bootstrap calls on the "
            f"standard key, K3 {k3_lat} = one per latency call; the ops' {sum(r[3] for r in rows)} "
            f"lookups in {total_ms:.1f} ms on {card}")
    finally:
        rot.remove()
    pre = tlwe.add_to_body(ct, (1 << 32) // (4 * PBS_SPACE))
    return ctx, lat, (k1_total, kara_total), k3_lat, pre, tables


def pbs_breakdown(ctx, pre, tables, dev, card) -> None:
    """One PBS pass of ``pre``'s rows (the half-bucket offset already
    added), a table per row, layer by layer (host clock around
    synchronised work) under ``torch.profiler``: the test vector, the blind
    rotation, the extraction, the key switch; the device's busy and idle
    share, K1's kernels per step and the allocator's peak."""
    p = PBS_PARAMS

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tv, t_tv = timed(lambda: pbs.lut_testvec(tables, PBS_SPACE, p, device=dev))
        acc, t_rot = timed(lambda: bootstrap.blind_rotate(pre, ctx.ck.bk, tv, p))
        lv1, t_ext = timed(lambda: trlwe.sample_extract(acc, 0))
        lv0, t_ks = timed(lambda: bootstrap.identity_key_switch(lv1, ctx.ck.ksk, p))
        wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    dev_ms = device_times(prof)
    busy = sum(dev_ms.values())
    b = pre.shape[0]
    txt = (f"PBS pass at B={b}, a table per row, on {card}: test vector {t_tv:.2f} ms, blind "
           f"rotate {t_rot:.1f} ms ({t_rot / p.n:.3f} ms a step), extract {t_ext:.2f} ms, key "
           f"switch {t_ks:.2f} ms; pass {wall:.1f} ms ({b / wall * 1e3:.1f} lookups/s); "
           f"allocator peak {peak / 2**30:.3f} GiB")
    if busy > 0:
        k1 = {name: sum(v for k, v in dev_ms.items() if name in k) for name in K1_KERNELS}
        top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:4]
        txt += (f"; device busy {busy:.1f} ms, idle share {1 - busy / wall:.4f}; K1 "
                f"{sum(k1.values()) / busy:.2%} of device time (per step " + ", ".join(
                    f"{k} {v / p.n * 1e3:.1f} us" for k, v in k1.items())
                + "); top: " + "; ".join(f"{k[:50]} {v:.2f} ms" for k, v in top))
    else:
        txt += "; the profiler saw no device time (breakdown not measured)"
    log("pbs", txt)


def phase_pbs_kernels(ctx, lat, pre, tables, dev, card):
    """After the counts were read: K1 on the real PBS key against its plain
    version, steps 0, 1 and n-1 from the real first accumulators of the
    B=PBS_LOOKUPS batch (a test vector per row); K1's step time there and
    at B=4096 beside the plain step and its bound; K3's rotation at B=1 on
    the real latency key against the K1 loop, its time and device time per
    step.  Returns K1's and K3's largest errors."""
    p = PBS_PARAMS
    testvec = pbs.lut_testvec(tables, PBS_SPACE, p, device=dev)
    acc, a_steps = bootstrap.rotation_start(pre, testvec, p)
    del testvec
    err = 0
    got = acc
    for i in (0, 1, p.n - 1):
        nxt = cmux_k.cmux_step(got, a_steps[i], ctx.ck.bk[i], p)
        err = max(err, exact(f"K1 on the PBS key bk[{i}], B={acc.shape[0]}", nxt,
                             cmux_k.cmux_step_plain(got, a_steps[i], ctx.ck.bk[i], p)))
        got = nxt
    log("pbs", f"K1 bit-exact against its plain version on the PBS_PARAMS key (steps 0, 1 and "
        f"{p.n - 1}) from the real first accumulators, a test vector per row, B={acc.shape[0]}")
    key_bytes = 2 * p.l * 2 * 2 * p.N * 4
    for b in (4096, acc.shape[0]):
        ab, ai = acc[:b].contiguous(), a_steps[0, :b].contiguous()
        t = turns({"K1": lambda: cmux_k.cmux_step(ab, ai, ctx.ck.bk[0], p),
                   "plain": lambda: cmux_k.cmux_step_plain(ab, ai, ctx.ck.bk[0], p)}, 3)
        bnd, by = bound(step_ops(p, b), step_bytes(p, b, key_bytes))
        log("pbs", f"K1 step at PBS_PARAMS, B={b} on {card}: {t['K1']:.4f} ms (plain "
            f"{t['plain']:.3f} ms); bound {bnd:.4f} ms ({by}), {bnd / t['K1']:.1%} of it; "
            f"a pass of {p.n} steps {t['K1'] * p.n:.1f} ms -> {b / (t['K1'] * p.n) * 1e3:.1f} "
            "lookups/s by K1 alone")
    del acc, a_steps, got
    pbs_breakdown(ctx, pre[:4096], tables[:4096], dev, card)
    a1, s1 = bootstrap.rotation_start(pre[:1], pbs.lut_testvec(tables[:1], PBS_SPACE, p,
                                                               device=dev), p)
    k3_out = rotate_all_k.rotate_all(a1, s1, lat.ck.bk.bk, p)
    err3 = exact("K3 on the PBS key, B=1", k3_out, k1_loop(a1, s1, ctx.ck.bk, p))
    # One launch per rotation, milliseconds long: back to back, the events
    # time the kernel itself (a profiler session here, after the layered
    # pass's, has recorded nothing).
    ms = cuda_ms(lambda: rotate_all_k.rotate_all(a1, s1, lat.ck.bk.bk, p), 3)
    bnd, by = bound(*k3_work(p, 1))
    log("pbs", f"K3 at PBS_PARAMS, B=1, on the real latency key: equal to the K1 loop word for "
        f"word; {ms:.3f} ms a rotation (CUDA events, 3 launches back to back), "
        f"{ms / p.n * 1e3:.2f} us a step; bound {bnd:.4f} ms ({by}); clusters of "
        f"{rotate_all_k.cluster_for(1, p, dev)} on {card}")
    return err, err3


# --------------------------------------------------------------------- #
# 15. Seeded ciphertexts: the threefry expansion on the card
# --------------------------------------------------------------------- #
# The mask words JAX draws from the seed (1, 2) for 5 bodies (jax 0.9.0,
# jax_threefry_partitionable): row 0's first four, row 4's last four and
# the sum of all mod 2^32, at DEFAULT_PARAMS' and PBS_PARAMS' n; the same
# words as tests/test_torch_seeded.py, which holds them to JAX.
PINNED_SEED = (1, 2)
PINNED_MASK = {
    635: ((0xAECE9DD7, 0x6BFF9E1C, 0x7DC7F1B1, 0x0A49EB5F),
          (0xDFD6BF01, 0x6490C046, 0x4C270E27, 0x1BBBD63B), 0xA3FA4106),
    714: ((0xAECE9DD7, 0x6BFF9E1C, 0x7DC7F1B1, 0x0A49EB5F),
          (0x45777175, 0xA3A4A928, 0x2C007A48, 0xFB28C83E), 0xDFF4689F),
}
EXPAND_BATCH = 131072  # the port bench's batch: B x n mask words to expand


def check_seeded_expansion(c, dev) -> None:
    """At ``c``'s n: the pinned JAX mask words expanded on the card, and a
    seeded upload of MIXED bits expanded on the card against the CPU's
    expansion of the same (seed, bodies), word for word."""
    n = c.params.n
    a = _u32.to_numpy(tlwe.expand_seeded(np.asarray(PINNED_SEED, np.uint32),
                                         torch.zeros(5, dtype=torch.int32, device=dev), n))[:, 1:]
    got = (tuple(int(v) for v in a[0, :4]), tuple(int(v) for v in a[4, -4:]),
           int(a.astype(np.uint64).sum()) & 0xFFFFFFFF)
    if got != PINNED_MASK[n]:
        raise AssertionError(f"seeded: the card's mask words at n={n} are not JAX's")
    seed, body = c.encrypt_seeded(np.arange(MIXED) % 2)
    card_ct = c.cloud_only().expand_seeded((seed, body))
    if card_ct.device != dev:
        raise AssertionError(f"seeded: the expansion ran on {card_ct.device}, not {dev}")
    exact(f"seeded expansion at n={n}, card vs CPU", card_ct,
          tlwe.expand_seeded(seed.cpu(), body.cpu(), n))


def phase_seeded(ctx, pbs_ctx, dev, card):
    """Seeded uploads on phase 4's DEFAULT context and phase 14's PBS
    context: the expansion on the card against the CPU's and JAX's pinned
    words; the mixed truth-table batch from seeded uploads through K1 on a
    cloud-only context; a seeded FheUint 8-bit + and a seeded RadixUint
    add at PBS_PARAMS at INT_PAIRS lanes, each expanded cloud-only and
    decrypted; a save/load round trip; the expansion's time and allocator
    peak at EXPAND_BATCH x n.  Returns K1's launches in this phase."""
    from rustfhe_tpu_torch import FheUint
    from rustfhe_tpu_torch.utils import serialization as ser

    p = DEFAULT_PARAMS
    t15 = time.perf_counter()
    for c in (ctx, pbs_ctx):
        check_seeded_expansion(c, dev)
    log("seeded", f"the threefry expansion on {dev} equals the CPU's word for word at n={p.n} "
        f"and n={PBS_PARAMS.n} ({MIXED} bodies), and JAX's pinned mask words of the seed "
        f"{PINNED_SEED}")

    cmux_k.reset_counters()
    cloud, pcloud = ctx.cloud_only(), pbs_ctx.cloud_only()
    _, pre, _, want = mixed_batch(ctx, p, lambda bits: cloud.expand_seeded(
        ctx.encrypt_seeded(bits)))
    out = one_pass(lambda: cloud.bootstrap_raw(pre), p)
    check_bits("seeded mixed batch", ctx.decrypt(out).cpu().numpy(), want)
    rs = np.random.RandomState(SEED + 15)
    av, bv = (rs.randint(0, 256, INT_PAIRS, dtype=np.uint64) for _ in range(2))

    def uint_add():
        a, b = (FheUint.expand_seeded(cloud, FheUint.encrypt_seeded(ctx, v, 8)) for v in (av, bv))
        return FheUint(ctx, (a + b).bits).decrypt()

    def radix_add():
        a, b = (radix.RadixUint.expand_seeded(pcloud, radix.RadixUint.encrypt_seeded(pbs_ctx, v, 4))
                for v in (av, bv))
        return radix.RadixUint(pbs_ctx, (a + b).digits).decrypt()

    txt = []
    for name, q, fn in (("FheUint 8-bit +", p, uint_add),
                        ("RadixUint add at PBS_PARAMS", PBS_PARAMS, radix_add)):
        before = cmux_k.cmux_step.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        ms = (time.perf_counter() - t0) * 1e3
        k1 = cmux_k.cmux_step.launches - before
        if k1 == 0 or k1 % q.n:
            raise AssertionError(f"seeded: {name} launched K1 {k1} times (n = {q.n} a level)")
        check_bits(f"seeded {name}", got, (av + bv) & np.uint64(255))
        txt.append(f"a seeded {name} at {INT_PAIRS} lanes {ms:.1f} ms ({k1 // q.n} levels)")
    k1, kara = cmux_k.cmux_step.launches, cmux_k.cmux_step_karatsuba.launches
    log("seeded", f"cloud-only on {card}: the mixed batch of {MIXED} gates from seeded uploads "
        f"through K1, every output right; {'; '.join(txt)} (upload, expansion, the op and the "
        f"decryption), every value right; K1 launched {k1} times")

    with tempfile.TemporaryDirectory() as tmp:
        seeded = ctx.encrypt_seeded(np.arange(MIXED) % 2)
        paths = [os.path.join(tmp, f) for f in ("seeded.npz", "full.npz")]
        ser.save_seeded_ciphertexts(paths[0], seeded, p)
        ser.save_ciphertexts(paths[1], ctx.expand_seeded(seeded), p)
        cts, params = ser.load_seeded_ciphertexts(paths[0], device=dev)
        if params != p:
            raise AssertionError("seeded: the npz round trip changed the parameters")
        exact("seeded npz round trip", cts, ctx.expand_seeded(seeded))
        sizes = [os.path.getsize(f) for f in paths]
    log("seeded", f"npz round trip of {MIXED} ciphertexts: {sizes[0]} bytes seeded, {sizes[1]} "
        f"expanded, {sizes[1] / sizes[0]:.1f}x")

    b = torch.zeros(EXPAND_BATCH, dtype=torch.int32, device=dev)
    seed = torch.tensor(PINNED_SEED, dtype=torch.int32, device=dev)
    tlwe.expand_seeded(seed, b, p.n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ct = tlwe.expand_seeded(seed, b, p.n)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        del ct
    peak = torch.cuda.max_memory_allocated(dev) - base
    words = EXPAND_BATCH * p.n
    log("seeded", f"expansion of {EXPAND_BATCH} x {p.n} = {words / 1e6:.1f} M mask words on "
        f"{card}: " + ", ".join(f"{t:.2f}" for t in ms) + f" ms (host clock around synchronised "
        f"work), {words / min(ms) / 1e6:.2f} G words/s; allocator peak {peak / 2**30:.3f} GiB "
        f"above the bodies ({words * 4 / 2**30:.3f} GiB of output)")
    log("seeded", f"phase 15 in {time.perf_counter() - t15:.1f} s")
    return k1, kara


# --------------------------------------------------------------------- #
# 16. The scale-out path (parallel/) and hybrid keys
# --------------------------------------------------------------------- #
PARALLEL_GATES = ("nand", "and", "or", "xor", "not", "mux")
TP_BATCH = 1024  # the tensor-parallel "matmul" gate's batch
SHARDED_PBS = (4096, 4, 2)  # rows, space, t of the sharded multi-output PBS
DEGREE_BATCH = 64  # digit rows of the degree-sharded product at N=1024


def host_ms(fn) -> tuple[object, float]:
    """(result, ms) of ``fn`` on the host clock around synchronised work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def host_turns(fns: dict, rounds: int = 1) -> dict:
    """Host-clock ms of each function in turns (a, b, ..., ..., b, a),
    ``rounds`` times; the mean of each."""
    order = (list(fns) + list(fns)[::-1]) * rounds
    acc = {k: [] for k in fns}
    for k in order:
        acc[k].append(host_ms(fns[k])[1])
    return {k: sum(v) / len(v) for k, v in acc.items()}


def counts() -> dict:
    """The launch counts phase 16 reads."""
    return {"k1": cmux_k.cmux_step.launches, "k1_panel": cmux_k.cmux_step_panel.launches,
            "k1_karatsuba": cmux_k.cmux_step_karatsuba.launches,
            "key_panel": cmux_k.key_panel.launches, "k2": cmux_k.external_product.launches,
            "k3": rotate_all_k.rotate_all.launches, "p9": int8_gemm.int8_matmul.launches}


def delta(before: dict) -> dict:
    now = counts()
    return {k: now[k] - before[k] for k in now}


def expect(what: str, got: dict, **want) -> None:
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"{what}: launches (got, expected) {bad}")


def expect_levels(what: str, d: dict, kernel: str, n: int) -> int:
    """The levels an op ran on ``kernel`` alone ("k1": n launches a level;
    "k3": one a level), from its launch counts ``d``."""
    other = "k3" if kernel == "k1" else "k1"
    per = n if kernel == "k1" else 1
    if d[kernel] == 0 or d[other] or d[kernel] % per:
        raise AssertionError(f"{what}: launches {d}, expected levels on {kernel} alone")
    return d[kernel] // per


def phase_parallel(ctx, pbs_ctx, dev, card):
    """The scale-out path on a world of one process (NCCL) and a (1, 1)
    mesh on the card, at DEFAULT_PARAMS on phase 4's keys and timed batch:
    the six sharded gates under both key switches, the sharded bootstrap
    in turns with the unsharded pass, the tensor-parallel "matmul" gate,
    the sharded PBS at PBS_PARAMS on phase 14's context, a GateSession with
    its own keygen (FheUint adds on K1 and, in latency mode, on K3), and
    the degree-sharded product; then hybrid keys with and without full
    panels.  Returns the phase's launch counts."""
    from rustfhe_tpu_torch import FheUint
    from rustfhe_tpu_torch.keys import cloud_key_hybrid
    from rustfhe_tpu_torch.parallel import (make_mesh, multihost, shard_cloud_key,
                                            shard_cloud_key_tp, sharded_bootstrap_fn,
                                            sharded_gate_fn, sharded_pbs_fn, tp_gate_fn)
    from rustfhe_tpu_torch.parallel.degree_sharded import (
        degree_sharded_external_product_fn, shard_transform_panels)

    p = DEFAULT_PARAMS
    t16 = time.perf_counter()
    start = counts()
    rs = np.random.RandomState(SEED + 16)
    multihost.initialize(device=dev)
    try:
        mesh = make_mesh()
        _, ms = host_ms(lambda: torch.distributed.all_reduce(torch.zeros(1, device=dev)))
        log("parallel", f"world of {torch.distributed.get_world_size()} on "
            f"{torch.distributed.get_backend()}, mesh {tuple(mesh.mesh.shape)} "
            f"{mesh.mesh_dim_names} on {mesh.device_type}; the first collective (the "
            f"communicator's setup) {ms:.1f} ms")

        # The six gates under both key switches, against the context's gates.
        bits = rs.randint(0, 2, size=(3, BATCH))
        cts = [ctx.encrypt(b) for b in bits]
        args = {"not": cts[:1], "mux": cts}
        ref = {kind: getattr(ctx, kind if kind in ("nand", "xor", "mux") else kind + "_")(
            *args.get(kind, cts[:2])) for kind in PARALLEL_GATES}
        x, y, z = bits
        truth = dict(TRUTH, mux=lambda x_, y_: np.where(x_ == 1, z, y_))
        for kind in PARALLEL_GATES:
            check_bits(f"parallel {kind}", ctx.decrypt(ref[kind]).cpu().numpy(),
                       truth[kind](x, y))
        times = {}
        for ks, axis in (("psum", "model"), ("all_to_all", "data")):
            ck = shard_cloud_key(ctx.ck, mesh, axis=axis)
            for kind in PARALLEL_GATES:
                fn = sharded_gate_fn(mesh, p, kind=kind, key_switch=ks)
                before = counts()
                out, times[ks, kind] = host_ms(
                    lambda: fn(ck.bk, ck.ksk, *args.get(kind, cts[:2])))
                passes = 2 if kind == "mux" else 1  # MUX: the two ANDs as one batch, the OR
                expect(f"sharded {kind} ({ks})", delta(before), k1=passes * p.n)
                exact(f"sharded {kind} ({ks})", out, ref[kind])
        log("parallel", f"all six gates at B={BATCH} under the model all_reduce key switch and "
            f"the all_to_all key switch equal the context's unsharded gates word for word (K1 "
            f"{p.n} launches a pass); ms: " + ", ".join(
                f"{kind} {times['psum', kind]:.1f}/{times['all_to_all', kind]:.1f}"
                for kind in PARALLEL_GATES) + f" (psum/all_to_all, host clock) on {card}")

        # The sharded bootstrap in turns with the unsharded pass.
        pre = gates.precombine("nand", cts[0], cts[1], params=p)
        ck = shard_cloud_key(ctx.ck, mesh)
        boot = sharded_bootstrap_fn(mesh, p)
        exact("sharded_bootstrap_fn", one_pass(lambda: boot(ck.bk, ck.ksk, pre), p), ref["nand"])
        before = counts()
        t = host_turns({"unsharded": lambda: ctx.bootstrap_raw(pre),
                        "sharded": lambda: boot(ck.bk, ck.ksk, pre)}, rounds=2)
        expect("sharded bootstrap in turns", delta(before), k1=8 * p.n)
        log("parallel", f"sharded_bootstrap_fn at B={BATCH}: {t['sharded']:.1f} ms a pass "
            f"against {t['unsharded']:.1f} ms unsharded ({t['unsharded'] / t['sharded']:.1%} of "
            f"the unsharded gates/s; in turns, 4 passes each, host clock), K1 {p.n} launches "
            f"a pass, on {card}")

        # The tensor-parallel "matmul" gate on phase 4's raw keys.
        table = get_engine("matmul").prepare_trgsw(ctx.ck.bk[..., p.N:], p)
        ck_tp = shard_cloud_key_tp(CloudKey(GenericBK(table, "matmul"), ctx.ck.ksk), mesh)
        tp = tp_gate_fn(mesh, p, "nand")
        a, b = cts[0][:TP_BATCH], cts[1][:TP_BATCH]
        before = counts()
        out, ms = host_ms(lambda: tp(ck_tp.bk, ck_tp.ksk, a, b))
        expect("tp_gate_fn", delta(before), p9=p.n, k1=0)
        exact("tp_gate_fn (matmul) vs the K1 path", out, ref["nand"][:TP_BATCH])
        log("parallel", f"tp_gate_fn on \"matmul\" at B={TP_BATCH} (2L = {2 * p.l} rows on "
            f"one model rank): equal to the K1 path word for word, {p.n} P9 launches, "
            f"{ms:.1f} ms (host clock) on {card}")
        del table, ck_tp

        # The sharded multi-output PBS at PBS_PARAMS on phase 14's context.
        q = PBS_PARAMS
        rows, space, tt = SHARDED_PBS
        xs = rs.randint(0, space, size=rows)
        tables = rs.randint(0, space, size=(tt, space))
        ct = pbs_ctx.encrypt_int(xs, space)
        want = pbs.pbs_many(pbs_ctx.ck, ct, tables, space=space, params=q)
        pck = shard_cloud_key(pbs_ctx.ck, mesh)
        before = counts()
        out, ms = host_ms(lambda: sharded_pbs_fn(mesh, q, space=space)(pck.bk, pck.ksk, ct,
                                                                        tables))
        expect("sharded_pbs_fn", delta(before), k1=q.n)
        exact("sharded_pbs_fn vs pbs_many", out, want)
        dec = pbs_ctx.decrypt_int(out, space).cpu().numpy()
        for j in range(tt):
            check_bits(f"sharded pbs lookup {j}", dec[:, j], tables[j][xs])
        log("parallel", f"sharded_pbs_fn at PBS_PARAMS, B={rows}, space {space}, t={tt}: equal "
            f"to pbs_many word for word, every lookup right, {ms:.1f} ms, K1 {q.n} launches, "
            f"on {card}")
        del pck, want, out, ct

        # GateSession: its own keygen, FheUint adds on K1 and on K3.
        av, bv = (rs.randint(0, 256, INT_PAIRS, dtype=np.uint64) for _ in range(2))
        for latency in (False, True):
            lanes = 1 if latency else INT_PAIRS
            sess, ms_keys = host_ms(lambda: multihost.GateSession(
                SEED + 16, p, latency_mode=latency, device=dev))
            a, b = (FheUint.encrypt(sess, v[:lanes], 8) for v in (av, bv))
            before = counts()
            got, ms = host_ms(lambda: (a + b).decrypt())
            d = delta(before)
            check_bits(f"GateSession FheUint add (latency {latency})", got,
                       (av[:lanes] + bv[:lanes]) & np.uint64(255))
            kernel = "k3" if latency else "k1"
            levels = expect_levels(f"GateSession (latency {latency})", d, kernel, p.n)
            log("parallel", f"GateSession(latency_mode={latency}) at DEFAULT_PARAMS on {dev}: "
                f"engine {sess.engine_name}, keygen and engine probe {ms_keys:.1f} ms; an 8-bit "
                f"FheUint add at {lanes} lane(s): {ms:.1f} ms, {levels} levels on "
                f"{kernel.upper()}, every value right, on {card}")
            del sess, a, b

        # The degree-sharded product at N=1024 against the "nuss" engine.
        nuss = get_engine("nuss")
        key_rows = words(rs, (2 * p.l, 2, p.N), dev)
        digits = torch.from_numpy(rs.randint(-p.half_bg, p.half_bg, size=(
            DEGREE_BATCH, 2 * p.l, p.N)).astype(np.int32)).to(dev)
        panels, ms_panels = host_ms(lambda: nuss.prepare_trgsw(key_rows, p))
        want, ms_nuss = host_ms(lambda: nuss.external_product_digits(panels, digits, p))
        fn = degree_sharded_external_product_fn(mesh, p)
        got, ms = host_ms(lambda: fn(shard_transform_panels(panels, mesh), digits))
        exact("degree-sharded product vs nuss", got, want)
        exact("nuss vs the oracle", want.cpu(),
              oracle.external_product(key_rows.cpu(), digits.cpu()))
        log("parallel", f"degree-sharded product at N={p.N}, {DEGREE_BATCH} digit rows: equal "
            f"to the nuss engine and the oracle word for word; {ms:.1f} ms against "
            f"{ms_nuss:.1f} ms unsharded (host clock; the panels built host-side in "
            f"{ms_panels:.0f} ms) on {card}")
    finally:
        multihost.shutdown()

    # Hybrid keys on phase 4's key, with and without full panels.
    pre = gates.precombine("nand", cts[0], cts[1], params=p)
    hybrid = {}
    for full in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        before = counts()
        hk, ms = host_ms(lambda: cloud_key_hybrid(ctx.ck, p, full_panels=full))
        expect(f"hybrid build (full {full})", delta(before),
               key_panel=p.n if full else p.n // 2)
        hb = hk.bk
        nbytes = sum(t.numel() * t.element_size() for t in (hb.prep_even, hb.panels_odd,
                                                             hb.prep_tail) if t.dtype == torch.int8)
        before = counts()
        out = gates.hom_bootstrap(hk, pre, params=p)
        torch.cuda.synchronize()
        expect(f"hybrid pass (full {full})", delta(before),
               k1=0 if full else p.n // 2 + p.n % 2, k1_panel=p.n if full else p.n // 2)
        exact(f"hybrid pass (full {full}) vs the K1 loop", out, ref["nand"])
        peak = torch.cuda.max_memory_allocated(dev) - base
        hybrid[full] = hk
        log("hybrid", f"cloud_key_hybrid(full_panels={full}) on phase 4's key: {nbytes / 1e9:.3f} "
            f"GB of prebuilt panels, built in {ms:.1f} ms; one pass at B={BATCH} equals the K1 "
            f"loop word for word with {p.n // 2 + p.n % 2 if not full else 0} key_panel launches "
            f"(the standard key: {p.n}) and {p.n if full else p.n // 2} panel steps; allocator "
            f"peak {peak / 2**30:.3f} GiB above the keys and inputs, on {card}")
    before = counts()
    t = host_turns({"standard": lambda: gates.hom_bootstrap(ctx.ck, pre, params=p),
                    "hybrid": lambda: gates.hom_bootstrap(hybrid[False], pre, params=p),
                    "full": lambda: gates.hom_bootstrap(hybrid[True], pre, params=p)},
                   rounds=3)
    expect("hybrid turns", delta(before), k1=6 * (p.n + p.n // 2 + p.n % 2),
           k1_panel=6 * (p.n // 2 + p.n))
    log("hybrid", f"passes at B={BATCH} in turns (6 each, host clock): standard key "
        f"{t['standard']:.1f} ms, hybrid {t['hybrid']:.1f} ms, full panels {t['full']:.1f} ms "
        f"on {card}")
    del hybrid
    torch.cuda.empty_cache()
    d = delta(start)
    log("parallel", f"phase 16 in {time.perf_counter() - t16:.1f} s; launches {d}")
    return d



# --------------------------------------------------------------------- #
# 17. Public-key encryption, the gate functions and the examples
# --------------------------------------------------------------------- #
PK_BATCH = 4096  # the public-key encryption batch
PLAIN_LANES = 32  # lanes of each gate held against K1's plain version
FP64_FLOPS_PER_S = 67e12  # float64 tensor-core peak of an H100 SXM (published)
# The ported examples, each run by its main() at its default knobs, and the
# start of its closing line.
EXAMPLES = {"client_server": "server computed NAND=", "homnand_bench": "not   OK",
            "adder_bench": "blind rotations:", "encrypted_compare": "ok",
            "encrypted_ints": "# all integer ops decode correctly", "lut_eval": "OK"}


def plain_gate(kind: str, ck, cts, p) -> torch.Tensor:
    """Gate ``kind`` of ``cts`` with K1's plain version in every step of
    each bootstrap, composed from the JAX package's formulas (MUX: both
    ANDs, then their OR); launches no kernel."""
    mu = trlwe.trivial(torch.full((p.N,), p.mu, dtype=torch.int32, device=cts[0].device))

    def boot(pre):
        acc, a_steps = bootstrap.rotation_start(pre, mu, p)
        for i in range(p.n):
            acc = cmux_k.cmux_step_plain(acc, a_steps[i], ck.bk[i], p)
        return bootstrap.identity_key_switch(trlwe.sample_extract(acc, 0), ck.ksk, p)

    if kind == "mux":
        control, in0, in1 = cts
        return boot(gates.precombine("or", boot(gates.precombine("and", control, in1, params=p)),
                                     boot(gates.precombine("andn", control, in0, params=p)),
                                     params=p))
    return boot(gates.precombine(kind, *cts, params=p))


def run_example(name: str, card: str) -> tuple[float, dict]:
    """``rustfhe_tpu_torch.examples.<name>.main()`` at its default knobs on
    the card, its lines logged as ``[example:<name>]``; (ms, launches)."""
    mod = importlib.import_module(f"rustfhe_tpu_torch.examples.{name}")
    buf = io.StringIO()
    before = counts()
    try:
        with contextlib.redirect_stdout(buf):
            _, ms = host_ms(lambda: mod.main() if name == "client_server" else mod.main([]))
    finally:
        for line in buf.getvalue().splitlines():
            log(f"example:{name}", line)
    lines = buf.getvalue().rstrip().splitlines()
    if not lines or not lines[-1].startswith(EXAMPLES[name]):
        raise AssertionError(f"{name}: no closing line {EXAMPLES[name]!r}")
    d = delta(before)
    if d["k1"] == 0 or d["k2"] == 0:
        raise AssertionError(f"{name}: launches {d}, expected K1 steps and the K2 probe")
    log("public", f"example {name} at its default knobs: {ms / 1e3:.2f} s, launches {d} "
        f"on {card}")
    return ms, d


def phase_public_key(ctx, dev, card):
    """Public-key encryption on phase 4's DEFAULT context: the key and its
    build time, ``encrypt_public`` at B=4096 (decrypted, timed beside its
    byte bound), the six ``gates.hom_*`` on public ciphertexts decrypted
    right and, on their first lanes, equal to the same gates on K1's plain
    version word for word (``plain_gate``); then each ported
    example's ``main()`` at its default knobs.  Returns the phase's launch
    counts."""
    p = DEFAULT_PARAMS
    t17 = time.perf_counter()
    start = counts()
    rs = np.random.RandomState(SEED + 17)
    pk, first_ms = host_ms(ctx.make_public_key)
    pk_ms = min(host_ms(ctx.make_public_key)[1] for _ in range(3))
    M = pk.shape[0]
    if (pk.shape != (2 * (p.n + 1), p.n + 1) or pk.dtype != torch.int32
            or pk.device != ctx.device):
        raise AssertionError(f"public key: {pk.dtype} {tuple(pk.shape)} on {pk.device}")
    noise = tlwe.phase(pk, ctx.sk.lv0).to(torch.float64).abs().max().item() / 2**32
    if noise > 8 * p.alpha_lv0:
        raise AssertionError(f"public key rows: |phase| {noise:.3g} above 8 sigma")
    log("public", f"make_public_key: ({M}, {p.n + 1}) int32, {pk.nbytes / 1e6:.2f} MB, "
        f"{first_ms:.2f} ms first, {pk_ms:.2f} ms (best of 3, host clock); every row's phase "
        f"within {noise / p.alpha_lv0:.2f} sigma of 0, on {card}")

    # encrypt_public on a cloud-only context with the caller's generator
    cloud = ctx.cloud_only()
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    bits = rs.randint(0, 2, size=(3, PK_BATCH))
    cts = [cloud.encrypt_public(pk, b, gen=gen) for b in bits]
    for i, (ct, b) in enumerate(zip(cts, bits)):
        check_bits(f"encrypt_public batch {i}", ctx.decrypt(ct).cpu().numpy(), b)
    mask = cloud.encrypt_public(pk.masked_fill(torch.arange(p.n + 1, device=dev) > 0, 0),
                                bits[0], gen=gen)[:, 1:]
    if not bool(mask.any()) or mask.abs().max().item() > 8 * p.alpha_lv0 * 2**32:
        raise AssertionError("encrypt_public: the mask noise is missing or above 8 sigma")
    bits0 = torch.from_numpy(bits[0]).to(dev)
    enc_ms = cuda_ms(lambda: cloud.encrypt_public(pk, bits0, gen=gen), 10)
    nbytes = (M + PK_BATCH) * (p.n + 1) * 4  # the key read once, the ciphertexts written
    bound_ms, _ = bound(0.0, nbytes)
    gemm_ms = 2.0 * PK_BATCH * M * (p.n + 1) / FP64_FLOPS_PER_S * 1e3
    log("public", f"encrypt_public at B={PK_BATCH}: {enc_ms:.4f} ms (CUDA events, mean of 10); "
        f"byte bound {bound_ms:.5f} ms ({nbytes / 1e6:.2f} MB: the key once and the output; "
        f"{bound_ms / enc_ms:.1%}); the float64 GEMM r^T pk alone, 2 x {PK_BATCH} x {M} x "
        f"{p.n + 1} ops over the published 67 TFLOP/s float64 peak, {gemm_ms:.4f} ms; "
        f"{PK_BATCH / enc_ms * 1e3:,.0f} encryptions/s; all {3 * PK_BATCH} decrypt right, "
        f"the mask carries noise, on {card}")

    # The six gate functions on public ciphertexts, against the same gates
    # on K1's plain version on their first lanes.
    c, x, y = cts
    fns = dict(gates.GATES_2IN, **{"not": gates.hom_not, "mux": gates.hom_mux})
    args = {"not": (x,), "mux": (c, x, y)}
    truth = dict(TRUTH, mux=lambda x_, y_: np.where(bits[0] == 1, y_, x_))
    times, plain_s = {}, 0.0
    for kind in PARALLEL_GATES:
        before = counts()
        out, times[kind] = host_ms(lambda: fns[kind](ctx.ck, *args.get(kind, (x, y)), params=p,
                                                     engine_name=ctx.engine_name))
        expect(f"gates.hom_{kind}", delta(before), k1=(2 if kind == "mux" else 1) * p.n)
        t0 = time.perf_counter()
        want = plain_gate(kind, ctx.ck, [a[:PLAIN_LANES] for a in args.get(kind, (x, y))], p)
        plain_s += time.perf_counter() - t0
        exact(f"gates.hom_{kind} against its plain version", out[:PLAIN_LANES], want)
        check_bits(f"gates.hom_{kind} on public ciphertexts", ctx.decrypt(out).cpu().numpy(),
                   truth[kind](bits[1], bits[2]))
    log("public", f"gates.hom_* on public ciphertexts at B={PK_BATCH} decrypt right, and their "
        f"first {PLAIN_LANES} lanes equal the same gates on K1's plain version word for word "
        f"({plain_s:.1f} s); ms: " + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
        + f" (host clock) on {card}")
    del cts, c, x, y, out

    # The ported examples at their default knobs, on the card.
    for name in EXAMPLES:
        run_example(name, card)
    torch.cuda.empty_cache()
    d = delta(start)
    log("public", f"phase 17 in {time.perf_counter() - t17:.1f} s; launches {d}")
    return d


# --------------------------------------------------------------------- #
# 18. The studies: the JAX package's benches/ scripts, ported
# --------------------------------------------------------------------- #
# Each study's run() with the keywords of this phase and why they differ
# from its defaults (None: the study's own defaults).
STUDIES = (
    ("multibit_probe", {}, None),
    ("keyswitch_probe", {}, None),
    ("latency_probe", dict(iters_largest=1), "B=32768 timed once (best of 5)"),
    ("repl_latency_probe", {}, None),
    ("pipeline_repl_probe", {}, None),
    ("unroll_probe", {}, None),
    ("hybrid_unroll_probe", dict(B=8192), "B=8192 (65536): the study's three rotations"),
    ("n2048_probe", {}, None),
    ("nuss_transform_probe", {}, None),
    ("noise_calibration_probe", {}, None),
    ("optimizer_probe", {}, None),
    ("adder_ab_probe", {}, None),
    ("karatsuba_probe", {}, None),
    ("kernels", {}, None),
)
# The kernels phase 18 must launch, by the kernels line's names, and the
# counters that count them.
STUDY_COUNTERS = {"K1": (cmux_k.cmux_step, cmux_k.cmux_step_panel),
                  "K2": (cmux_k.external_product,), "K3": (rotate_all_k.rotate_all,),
                  "K4": (limb_step.cmux_step_merged,), "P4": (karatsuba_probe.step_ablate,),
                  "P8": (karatsuba_probe.step_var,), "P9": (int8_gemm.int8_matmul,)}


def reset_all_counters() -> None:
    for mod in (cmux_k, limb_step, karatsuba_probe, int8_gemm):
        mod.reset_counters()
    rotate_all_k.rotate_all.launches = 0


def check_native(card: str) -> None:
    """The host library loaded, and its products equal to (u32, torus)
    and within 1e-9 of (f64) the numpy fallbacks at N=1024."""
    if not native.available():
        raise AssertionError("the host library of native.py did not build or load")
    rs = np.random.RandomState(SEED + 18)
    n = 1024
    a = rs.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    b = rs.randint(-32, 32, size=n).astype(np.int32)
    for name in ("negacyclic_mul_u32_exact", "negacyclic_mul_torus_fft"):
        got, want = getattr(native, name)(a, b), getattr(native, name + "_numpy")(a, b)
        if not np.array_equal(got, want):
            raise AssertionError(f"native.{name} differs from its numpy fallback")
    fa, fb = rs.standard_normal(n), rs.standard_normal(n)
    err = np.abs(native.negacyclic_mul_f64_fft(fa, fb)
                 - native.negacyclic_mul_f64_fft_numpy(fa, fb)).max()
    if err > 1e-9 * np.abs(fa).max() * np.abs(fb).max() * n:
        raise AssertionError(f"native.negacyclic_mul_f64_fft: {err} from the numpy fallback")
    t_lib, _ = time_fn(native.negacyclic_mul_u32_exact, a, b)
    t_np, _ = time_fn(native.negacyclic_mul_u32_exact_numpy, a, b)
    log("studies", f"host library {native.build().name}: u32 and torus products equal to the "
        f"numpy fallbacks at N={n}, f64 within {err:.3g}; the exact product {t_lib * 1e3:.3f} "
        f"ms (numpy {t_np * 1e3:.3f} ms; best of 3, host clock) on the card's host ({card})")


def phase_studies(card: str) -> dict[str, int]:
    """Each study's ``run(out=...)`` on the card (``STUDIES``), every
    launch counter set to 0 just before it and read just after; every
    kernel of ``STUDY_COUNTERS`` must launch in the phase.  Returns the
    phase's launches by kernel."""
    t18 = time.perf_counter()
    check_native(card)
    total = dict.fromkeys(STUDY_COUNTERS, 0)
    kara = 0  # K1's steps on the Karatsuba product, among "K1"
    for name, kwargs, cut in STUDIES:
        mod = importlib.import_module(f"rustfhe_tpu_torch.benches.{name}")
        reset_all_counters()
        t0 = time.perf_counter()
        mod.run(out=functools.partial(log, f"study:{name}"), **kwargs)
        got = {k: sum(c.launches for c in cs) for k, cs in STUDY_COUNTERS.items()}
        for k, v in got.items():
            total[k] += v
        kara += cmux_k.cmux_step_karatsuba.launches
        log("studies", f"{name}: {time.perf_counter() - t0:.1f} s, launches "
            f"{ {k: v for k, v in got.items() if v} }"
            + (f"; cut for this phase: {cut}" if cut else "; the study's defaults"))
        torch.cuda.empty_cache()
    missing = [k for k, v in total.items() if not v]
    if missing:
        raise AssertionError(f"phase 18 launched no {', '.join(missing)}")
    log("studies", f"phase 18 in {time.perf_counter() - t18:.1f} s; launches {total} ({kara} "
        f"of K1's on the Karatsuba product) on {card}")
    return total | {"K1 Karatsuba": kara}


def main() -> int:
    if len(sys.argv) > 1:
        print("usage: python3 chip_smoke.py  (it takes no arguments)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    for knob in ("KEYFILE", "RUSTFHE_FORCE_CPU", "RUSTFHE_ENGINE"):  # every phase at the defaults
        os.environ.pop(knob, None)
    p = DEFAULT_PARAMS
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

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
    host_lib = native.build()
    cmux_k.load_library()
    rotate_all_k.load_library()
    limb_step.load_library()
    limb_probe.load_library()
    int8_gemm.load_library()
    karatsuba_probe.load_library()
    nuss_primitives.load_library()
    log("build", f"{', '.join(lib.name for lib, _ in libs.values())} and the host library "
        f"{host_lib.name} from rustfhe_tpu_torch/csrc in {time.perf_counter() - t0:.2f} s")
    for lib, report in libs.values():
        for line in report.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "C75")):
                log("build", "ptxas: " + line.strip())
    regs = {}
    for lib, what, names in (("cmux_k", "K1/K2", K1_KERNELS),
                             ("limb_step", "K4/K6/K5", LIMB_KERNELS),
                             ("rotate_all_k", "K3", K3_KERNELS),
                             ("limb_probe", "P5/P6", PROBE_KERNELS),
                             ("karatsuba_probe", "P1-P4/P8", KARATSUBA_KERNELS)):
        regs[lib] = ptxas_kernels(libs[lib][1], names)
        if not regs[lib]:  # a cached library has no report
            continue
        log("build", f"{what} kernels (registers, spill bytes): " + ", ".join(
            f"{k} {r}, {sp}" for k, (r, sp) in regs[lib].items()))
        if any(sp for _, sp in regs[lib].values()) or "C75" in libs[lib][1]:
            raise AssertionError(f"a {what} kernel spills or ptxas serialised its wgmmas")

    # 3. kernels against their plain versions
    rs = np.random.RandomState(SEED)
    errs, times = phase_kernels(p, dev, rs)

    # 4-5. the main path, with the launch counts of this run only
    cmux_k.reset_counters()
    ctx, mixed_pre, mixed_out, mixed_want = phase_main_path(p, dev)
    cx, cy, nand_passes = phase_nand(ctx, p, card)
    passes = 2 + nand_passes
    launches = {"k1": cmux_k.cmux_step.launches, "k2": cmux_k.external_product.launches,
                "k1_karatsuba": cmux_k.cmux_step_karatsuba.launches}
    if launches["k1"] != passes * p.n or launches["k2"] < 1:
        raise AssertionError(f"main path launches {launches}, expected K1 = {passes * p.n} "
                             "and K2 >= 1")
    log("main", f"K1 launched {launches['k1']} times ({passes} passes x {p.n} steps; "
        f"{launches['k1_karatsuba']} of them on the Karatsuba product), K2 {launches['k2']} "
        "(the engine probe)")

    # 6. K1 on the real key, after the main path's counts were read
    nand_pre = gates.precombine("nand", cx, cy, params=p)
    err = phase_real_key(ctx, p, (mixed_pre, nand_pre))  # both products' rotations
    errs["k1"], errs["k1_karatsuba"] = max(errs["k1"], err), max(errs["k1_karatsuba"], err)
    k1_key = ctx.ck.bk[0].clone()  # phase 12 times K1's step beside the matmul step
    del cx, cy, nand_pre  # phase 13 runs on phase 4's context and keys

    # 7. the latency path: K3 checks and times, then the console with the
    # launch counts of its run only, then K3 on the real latency key
    errs["k3"], k3_times = phase_latency_kernels(p, dev, rs, card, regs["rotate_all_k"])
    lat = phase_console(p, dev, card)
    err, lat_ctx = phase_latency_real_key(p, dev, SEED)
    errs["k3"] = max(errs["k3"], err)
    phase_latency_profile(lat_ctx, p, card)
    del lat_ctx

    # 8. the limb engine: K4, K6 and K5 against their plain versions and
    # their times; the FAST_PARAMS path (K4 on every step) with the launch
    # counts of its run only; DEFAULT_PARAMS through K4, K6 and K5 per step
    limb_errs, limb_times = phase_limb_kernels(dev, rs, card, regs["limb_step"])
    errs.update(limb_errs)
    fast = phase_fast_path(dev, card)
    dflt = phase_default_limb(dev, card, mixed_pre, mixed_out, mixed_want)

    # 9. the probes: P5, P6, P7, P9 against their plain versions and their
    # times; then their entry points with the launch counts of each run
    probe_errs, probe_t, gemm_t = phase_probe_kernels(dev, rs, card)
    errs.update(probe_errs)
    probes = phase_probe_entry_points(card)

    # 10. the Karatsuba step probes: P4, P8, P1, P2 against their plain
    # versions and K1, their times; then their entry points with the launch
    # counts of each run
    kara_errs, kara_t, kara_b = phase_karatsuba_kernels(dev, rs, card)
    pbs_err, _ = phase_karatsuba_pbs(dev, rs, card)
    kara_errs["P4"] = max(kara_errs["P4"], pbs_err)
    kara = phase_karatsuba_entry_points(card)

    # 11. P3 and P10: against the production step, the matmul engine and
    # the host reference, their times; then their entry points with the
    # launch counts of each run
    p3_err, p3_t = phase_coissue(dev, rs, card)
    kara_errs["P3"] = max(kara_errs["P3"], p3_err)
    p10_err, (p10_ms, p10_plain_ms, p10_bytes) = phase_nuss_primitives(dev, card)
    kara["P3"], p10_launches = phase_coissue_entry_points(card)

    # 12. the generic-engine path at DEFAULT_PARAMS, with the launch counts
    # of its run only; then the other generic engines and Bg = 2^9
    phase_matmul_path(dev, card, mixed_pre, mixed_out, mixed_want, k1_key)
    phase_generic_engines(dev, card)

    # 13. the encrypted-integer path on phase 4's context, with the launch
    # counts of its run only; then K3 against the K1 loop; then the bench
    phase_integers(ctx, p, dev, card)

    # 14. PBS and the radix integers at PBS_PARAMS, with the launch counts
    # of its run only; then K1 and K3 on the real PBS keys
    t14 = time.perf_counter()
    pbs_ctx, pbs_lat, (k1_pbs, kara_pbs), k3_pbs, pbs_pre, pbs_tables = phase_pbs(dev, card)
    k1_err, k3_err = phase_pbs_kernels(pbs_ctx, pbs_lat, pbs_pre, pbs_tables, dev, card)
    errs["k1"], errs["k3"] = max(errs["k1"], k1_err), max(errs["k3"], k3_err)
    del pbs_lat, pbs_pre
    log("pbs", f"phase 14 in {time.perf_counter() - t14:.1f} s")

    # 15. seeded uploads on phase 4's and phase 14's contexts, with the
    # launch counts of their run only
    k1_seeded, kara_seeded = phase_seeded(ctx, pbs_ctx, dev, card)

    # 16. the scale-out path (parallel/) and hybrid keys on phase 4's and
    # phase 14's contexts, with the launch counts of their run only
    par = phase_parallel(ctx, pbs_ctx, dev, card)
    del pbs_ctx

    # 17. public-key encryption, the gate functions and the ported examples
    # on phase 4's context, with the launch counts of their run only
    pub = phase_public_key(ctx, dev, card)
    del ctx

    # 18. the studies, each with the launch counts of its run only
    studies = phase_studies(card)

    F = FAST_PARAMS
    fast_t = limb_times["FAST"]
    two_l, f_two_l = 2 * p.l, 2 * F.l
    key_bytes = two_l * 2 * 2 * p.N * 4  # K1's doubled int32 table
    limb_bytes = two_l * 2 * 4 * 2 * p.N  # the int8 limb table at DEFAULT
    f_limb_bytes = f_two_l * 2 * 4 * 2 * F.N
    b_k2, b_k5 = probe_vectors(p)[1].shape[0], probe_vectors(F)[1].shape[0]
    # K1's steps, and those among them on the Karatsuba product, in the counted phases
    k1_all = (launches["k1"] + k1_pbs + k1_seeded + par["k1"] + par["k1_panel"] + pub["k1"]
              + studies["K1"])
    k1_kara = (launches["k1_karatsuba"] + kara_pbs + kara_seeded + par["k1_karatsuba"]
               + pub["k1_karatsuba"] + studies["K1 Karatsuba"])
    leaf_bytes = int(np.prod(karatsuba.table_shape(p)))  # a step's leaf table
    rows = [  # name, source, replaces, launches, error, ms, plain ms, (ops, bytes), library ms
        ("cmux_rotate_k: key_panel_kernel + step_digits_kernel + cmux_product_kernel<true, 1>",
         KERNEL_SOURCE, "rustfhe_tpu/engine/pallas_k.py:295", k1_all - k1_kara,
         errs["k1"], *times["k1"], (step_ops(p, BATCH), step_bytes(p, BATCH, key_bytes)), None),
        ("cmux_rotate_karatsuba: limb_panel_kernel<9> + leaf_digits_kernel + "
         "cmux_product_kernel<false, 1, LeafProduct<RECOMBINE, false, 0>> + leaf_combine_kernel",
         KARATSUBA_STEP_SOURCE, "rustfhe_tpu/engine/pallas_k.py:295", k1_kara,
         errs["k1_karatsuba"], *times["k1_karatsuba"],
         (step_ops(p, BATCH), step_bytes(p, BATCH, leaf_bytes)), None),
        ("external_product_k: key_panel_kernel + cmux_product_kernel<false, 1>", KERNEL_SOURCE,
         "rustfhe_tpu/engine/pallas_k.py:506",
         launches["k2"] + par["k2"] + pub["k2"] + studies["K2"], errs["k2"], *times["k2"],
         (step_ops(p, b_k2), b_k2 * two_l * p.N + key_bytes + b_k2 * 2 * p.N * 4), None),
        ("rotate_all_k: rotate_all_kernel<TILES> (mma.sync s8, one cluster per sample)",
         K3_SOURCE, "rustfhe_tpu/engine/pallas_k.py:432",
         lat["k3"] + k3_pbs + par["k3"] + pub["k3"] + studies["K3"],
         errs["k3"],
         k3_times[1][0], k3_times[1][2], k3_work(p, 1), None),
        ("limb_cmux_step_merged: limb_panel_kernel + step_digits_kernel + "
         "cmux_product_kernel<true, 2>", LIMB_SOURCE, "rustfhe_tpu/engine/pallas_step.py:363",
         fast["k4"] + studies["K4"], errs["k4"], fast_t["step"]["k4"], fast_t["step"]["plain"],
         (step_ops(F, BATCH), step_bytes(F, BATCH, f_limb_bytes)), None),
        ("limb_external_product: limb_panel_kernel + cmux_product_kernel<false, 1>", LIMB_SOURCE,
         "rustfhe_tpu/engine/pallas_step.py:158",
         dflt["k5"], errs["k5"], fast_t["k5_probe"]["k5"], fast_t["k5_probe"]["plain"],
         (step_ops(F, b_k5), b_k5 * f_two_l * F.N + f_limb_bytes + b_k5 * 2 * F.N * 4), None),
        ("limb_cmux_step_split: limb_panel_kernel + step_digits_kernel + "
         "cmux_product_kernel<true, 1>", LIMB_SOURCE, "rustfhe_tpu/engine/pallas_step.py:267",
         dflt["k6"], errs["k6"], fast_t["step"]["k6"], fast_t["step"]["plain"],
         (step_ops(F, BATCH), step_bytes(F, BATCH, f_limb_bytes)), None),
        ("limb_probe_order: limb_panel_kernel<1> + step_digits_kernel<true> + "
         "cmux_product_kernel<true, 2, Drain> (j-outer; limb-outer: <true, 2>)", PROBE_SOURCE,
         "benches/limb_order_probe.py:85", probes["p5"], errs["p5"], probe_t["P5 j-outer"],
         probe_t["plain"],
         (step_ops(p, PROBE_CHECK[-1]), step_bytes(p, PROBE_CHECK[-1], limb_bytes)), None),
        ("limb_probe_variant: limb_panel_kernel<1> + step_digits_kernel<true> + "
         "cmux_product_kernel<true, 1> (full; norot: step_digits_kernel<false>; nodots: "
         "nodots_kernel)", PROBE_SOURCE, "benches/step_breakdown_probe.py:134", probes["p6"],
         errs["p6"], probe_t["P6 full"], probe_t["plain"],
         (step_ops(p, PROBE_CHECK[-1]), step_bytes(p, PROBE_CHECK[-1], limb_bytes)), None),
    ]
    for key, where in (("p7", "benches/step_breakdown_probe.py:175"),
                       ("p9", "benches/pallas_matmul_probe.py:56")):
        M, K, N = GEMM_SHAPES[key]
        rows.append((f"int8_gemm ({key.upper()})", GEMM_SOURCE, where,
                     probes[key] + (par["p9"] + studies["P9"] if key == "p9" else 0), errs[key],
                     min(gemm_t[key][tile] for tile in int8_gemm.TILES), gemm_t[key]["plain"],
                     (2.0 * M * K * N, M * K + K * N + 4 * M * N), gemm_t[key]["torch._int_mm"]))
    kara_bytes = step_bytes(p, kara_b, int(np.prod(karatsuba.table_shape(p))))  # the leaf table
    log("karatsuba", f"bound at B={kara_b}: {bound(step_ops(p, kara_b), kara_bytes)[0]:.4f} "
        f"ms (the Karatsuba step's {step_ops(p, kara_b):.4e} int8 ops; the schoolbook "
        f"count, {schoolbook_ops(p, kara_b):.4e} ops, would give "
        f"{bound(schoolbook_ops(p, kara_b), kara_bytes)[0]:.4f} ms)")
    kara_t["P3 B"] = p3_t["B"]  # the per-leaf form, timed in turns beside A and K1
    kara_step = ("tree_digits_kernel<V> + limb_panel_kernel<9> + cmux_product_kernel<false, 1, "
                 "LeafProduct<{}>> + combine_kernel<V>")
    for probe, name, label in (
            ("P4", "karatsuba_step_ablate (full): " + kara_step.format("RECOMBINE, false, 0"),
             "P4 full"),
            ("P8", "karatsuba_step_var (leaf_u32): " + kara_step.format("RECOMBINE, false, 0"),
             "P8 leaf_u32"),
            ("P1", "karatsuba_step_k2: " + kara_step.format("PER_LIMB, false, 0"), "P1 step_k2"),
            ("P2", "karatsuba_step_split (serial): " + kara_step.format("RECOMBINE, true, 0"),
             "P2 serial"),
            ("P3", "karatsuba_step_coissue (B): " + kara_step.format("RECOMBINE, false, 1"),
             "P3 B")):
        rows.append((name, KARATSUBA_SOURCE, KARATSUBA_REPLACES[probe],
                     kara[probe] + studies.get(probe, 0),
                     kara_errs[probe], kara_t[label], kara_t["plain"],
                     (step_ops(p, kara_b), kara_bytes), None))
    rows.append(("nuss_primitives", NUSS_SOURCE, "benches/nussbaumer_primitives_probe.py:57",
                 p10_launches, p10_err, p10_ms, p10_plain_ms, (0.0, p10_bytes), None))
    kernels = []
    for name, source, where, n, err, ms, plain_ms, (ops, nbytes), lib_ms in rows:
        bound_ms, bound_by = bound(ops, nbytes)
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": where,
                        "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
    log("done", f"chip_smoke.py ran in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
