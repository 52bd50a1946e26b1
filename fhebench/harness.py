"""One run of one cell: set-up, the measured window, the check, the line.

``run_cell`` finds everything by name.  The cell is an entry of
``BENCHMARK.json``'s ``workloads`` with its settings in
``workloads/<cell>.json``; its configuration is ``configs/<config>.json``;
its traffic mix is ``traffic/<mix>.json``, which names the generator
``traffic/<generator>.py``; each metric is ``metrics/<metric>.py``, whose
``read(run)`` returns a number or None.  A new cell, configuration, mix,
generator or metric is a new file and a new entry, never an edit here.

Order of a run:

1. set-up (``setup_s``, host clock from the process's start): the keys
   from the seed (``reference.tfhe.keygen``, on the device), the port's
   keys from the raw words (``keys.from_jax_keys``), the generator's
   encrypted inputs, one request of each kind to warm every shape;
2. the window: whole requests back to back, one in flight, each timed on
   the host clock around work that ends synchronised; it closes at the
   first block boundary at or after ``seconds``, so that every run does
   the same mix of work;
3. the device's peak memory is read, the program's keys are freed, and
   the generator's ``judge`` holds every output to the reference;
4. the metrics, then the line.

With ``trace`` the layer spans are on (``hooks.Spans``) from before the
warm-up, and a sub-window of ``profile_seconds`` (the cell's file), from
the second block on, runs under ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import hooks
from .reference import tfhe as ref

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "rustfhe_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A file of the benchmark as a module of its own (metric files carry
    dots in their names)."""
    name = "fhebench_file_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Record:
    req: object
    t0: float
    t1: float
    out: object = None


@dataclass
class Run:
    """What one run holds; the generator and the metric readers read it."""

    name: str
    seconds: float
    trace_on: bool
    device: torch.device
    cell: dict
    config: dict
    mix: dict
    params: object = None  # the port's TFHEParams
    rp: ref.Params = None  # the reference's parameters
    keys: ref.Keys = None
    ctx: object = None  # the port's TFHE context
    rng: np.random.Generator = None  # the schedule's and the samples' draws
    gen: torch.Generator = None  # the inputs' draws, on the device
    records: list = field(default_factory=list)
    start: float = 0.0
    setup_s: float = 0.0
    spans: hooks.Spans = None
    launches: dict = field(default_factory=dict)
    trace: object = None
    capture: hooks.Capture = None
    traffic: object = None

    @property
    def end(self) -> float:
        return self.records[-1].t1

    def units(self) -> float:
        return float(sum(self.traffic.units(r.req) for r in self.records))


def seeds(seed: int) -> list[int]:
    """Four independent 63-bit seeds from any whole number."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [int(x) >> 1 for x in ss.generate_state(4, dtype=np.uint64)]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts() -> dict[str, int]:
    """The port's launch counters: K1's steps, K1's steps on a prebuilt
    panel, K3's whole rotations."""
    from rustfhe_tpu_torch.engine import cmux_k, rotate_all_k

    fns = {"k1_steps": cmux_k.cmux_step, "k1_panel_steps": cmux_k.cmux_step_panel,
           "k3_rotations": rotate_all_k.rotate_all}
    return {k: getattr(fn, "launches", 0) for k, fn in fns.items()}


def metric_list(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def port_context(run: Run):
    """The port's context on the benchmark's keys: the raw words through
    ``keys.from_jax_keys`` as numpy uint32, prepared for the engine the
    port's rule picks (admitted on the device), and marked for the latency
    path where the cell says so."""
    from rustfhe_tpu_torch import keys as pkeys
    from rustfhe_tpu_torch.context import TFHE
    from rustfhe_tpu_torch.engine import select_engine
    from rustfhe_tpu_torch.params import TFHEParams

    p = TFHEParams(**{k: run.config[k] for k in ref.Params.__dataclass_fields__})
    run.params = p
    engine = select_engine(p, run.device)
    words = [t.cpu().numpy().view(np.uint32) for t in
             (run.keys.s0, run.keys.s1, run.keys.bk, run.keys.ksk)]
    sk, ck = pkeys.from_jax_keys(*words, p, run.device, engine=engine)
    if run.cell.get("latency_mode"):
        ck = pkeys.cloud_key_latency(ck)
    return TFHE(sk, ck, p, run.device, None, engine)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             bench: dict | None = None, root: Path = ROOT, t_start: float | None = None,
             tamper=None, log=None) -> dict:
    """Run one cell and return its result line as a dict.  ``tamper(run,
    patches)``, when given, replaces functions of the port once the keys
    and inputs are made (the control, a planted fault); every replacement
    is undone when the run ends."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = bench if bench is not None else load_json(BENCHMARK)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no cell {workload!r} in BENCHMARK.json")
    cell = {**entry, **load_json(root / "workloads" / f"{workload}.json")}
    config = load_json(root / "configs" / f"{entry['config']}.json")
    mix = load_json(root / "traffic" / f"{entry['traffic']}.json")
    generator = load_module(root / "traffic" / f"{mix['generator']}.py")
    metrics = [(m, load_module(root / "metrics" / f"{m['name']}.py"))
               for m in metric_list(bench, workload, trace)]
    device = torch.device(device)
    s_keys, s_inputs, s_sched, _ = seeds(seed)
    run = Run(workload, seconds, trace, device, cell, config, mix)
    run.rp = ref.Params.from_config(config)
    run.rng = np.random.default_rng(s_sched)
    run.gen = torch.Generator(device=device).manual_seed(s_inputs)
    patches = hooks.Patches()
    try:
        return _run(run, generator, metrics, patches, tamper, t_start, s_keys, log)
    finally:
        patches.restore()


def _run(run, generator, metrics, patches, tamper, t_start, s_keys, log) -> dict:
    device = run.device
    run.keys = ref.keygen(run.rp, torch.Generator(device=device).manual_seed(s_keys), device)
    run.ctx = port_context(run)
    traffic = generator.Traffic(run)
    run.traffic = traffic
    if tamper is not None:
        tamper(run, patches)
    chk = run.mix.get("check", {})
    run.capture = hooks.Capture(np.random.default_rng(run.rng.integers(1 << 62)),
                                chk.get("share", 0.0), chk.get("rows", 0), chk.get("cap", 0))
    if run.capture.cap:
        run.capture.install(patches, traffic.probes)
    if run.trace_on:
        run.spans = hooks.Spans()
        run.spans.install(patches, hooks.SPAN_TARGETS)
    for req in traffic.warm():
        traffic.send(req)
    sync(device)
    if run.spans:
        run.spans.reset()
    run.setup_s = time.perf_counter() - t_start
    log(f"# {run.name}: set-up {run.setup_s:.3f} s on {device}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    prof = region = done = None  # the profiler while it runs; once stopped, ``done``
    run.capture.on = True
    block = traffic.block
    run.start = time.perf_counter()
    i = 0
    while True:
        if run.trace_on and i == block:
            prof, region = _profile_start(device)
            prof_end = time.perf_counter() + float(run.cell.get("profile_seconds", 1.0))
        req = traffic.request(i)
        with (torch.profiler.record_function("fhebench.request") if run.trace_on
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            out = traffic.send(req)
            t1 = time.perf_counter()
        run.records.append(Record(req, t0, t1, out))
        i += 1
        if prof is not None and t1 >= prof_end:
            region.__exit__(None, None, None)
            prof.stop()
            done, prof = prof, None
        if t1 - run.start >= run.seconds and i % block == 0 and (
                not run.trace_on or done is not None):
            break
    run.capture.on = False
    sync(device)
    after = launch_counts()
    run.launches = {k: after[k] - before[k] for k in after}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    window = run.end - run.start
    log(f"# {run.name}: {len(run.records)} requests in {window:.3f} s")

    result_breakdown = None
    if done is not None:
        from .metrics import _trace

        fd, path = tempfile.mkstemp(suffix=".json", prefix="fhebench-trace-")
        os.close(fd)
        try:
            done.export_chrome_trace(path)
            run.trace = _trace.load(path)
        finally:
            os.unlink(path)
        if run.trace is not None:
            result_breakdown = _trace.breakdown(run.trace)

    # The program's state goes before the reference runs.
    run.ctx = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed = traffic.judge(run)
    log(f"# {run.name}: check {time.perf_counter() - t_check:.3f} s")

    values = {}
    for m, mod in metrics:
        v = mod.read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace_on:
        from .metrics import _trace

        dev["busy_s"] = _trace.busy_s(run.trace) if run.trace else 0.0
        dev["window_s"] = run.trace.window_s if run.trace else 0.0
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": len(run.records), "failed": failed,
              "metrics": values, "device": dev}
    if result_breakdown is not None:
        result["breakdown"] = result_breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def _profile_start(device):
    """Start the profiler and open the span that marks its window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync(device)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    region = torch.profiler.record_function("fhebench.profiled")
    region.__enter__()
    return prof, region


def forbidden_modules() -> list[str]:
    """Top-level names of ``sys.modules`` that are jax, jaxlib, flax or the
    JAX package, compared whole (``rustfhe_tpu_torch`` is not
    ``rustfhe_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
