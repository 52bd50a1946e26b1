"""The per-layer metrics that read the program's own spans
(``metrics/_program.py``), on the CPU stand-in cells:

* the program's spans count the rows the benchmark's wrappers
  (``hooks.Spans``) count: ``bootstrap`` as ``bootstrap_raw``, ``pbs`` as
  ``pbs`` + ``pbs_many``, and each ``blind_rotate`` as a
  ``blind_rotate#R#T`` label on the profiler's trace;
* the ``program_span`` and ``program_counter`` readers read numbers here,
  the ``device_trace`` readers none (no device operation on the CPU);
* the clock map and the device readers on a made-up trace;
* with no tracer in the program (a commit from before it), ``_program``
  imports and every reader returns None.
"""

from __future__ import annotations

import importlib.util
import sys
from collections import Counter
from types import SimpleNamespace

import pytest

import fhebench.metrics
from fhebench import harness
from fhebench.metrics import _trace
from fhebench.tests import standin
from rustfhe_tpu_torch.utils import trace

NEW = {"k1_host_us_per_step.uint": "program_span", "pad_rows_pct.uint": "program_counter",
       "plan_ms_per_expr.expr": "program_span",
       "keyswitch_idle_ms_per_level.expr": "device_trace",
       "rotate_device_us_per_level.expr": "device_trace",
       "launches_per_level.expr": "device_trace", "bitcircuit_share_pct.radix": "device_trace",
       "setup_port_s": "program_span"}
BENCH = harness.load_json(harness.BENCHMARK)


def forget_the_switch():
    sys.modules.pop("fhebench.metrics._program", None)
    if hasattr(fhebench.metrics, "_program"):
        delattr(fhebench.metrics, "_program")
    trace.enable(False)
    trace.clear()


@pytest.fixture(autouse=True)
def fresh_switch():
    """As in a process of its own: ``_program`` not yet imported (its import
    turns the tracer on); the tracer off and empty after each case."""
    forget_the_switch()
    yield
    forget_the_switch()


def traced(tmp_path, cell):
    """A traced stand-in run of ``cell``: its result line and its ``Run``."""
    held = []
    res = standin.run(tmp_path, cell, seed=2 ** 33 + 3, trace=True,
                      tamper=lambda run, patches: held.append(run))
    assert res["correct"]
    return res, held[0]


def reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py")


def in_window(run, name):
    from fhebench.metrics import _program

    return [r for r in _program.records(run) if r.name == name]


def test_the_entries():
    got = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NEW}
    assert {k: m["source"] for k, m in got.items()} == NEW
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(got["setup_port_s"]["workloads"]) == cells
    for name, m in got.items():
        if name != "setup_port_s":
            suffix = name.rsplit(".", 1)[1]
            assert [c.split(".")[0] for c in m["workloads"]] == [
                {"uint": "uint8"}.get(suffix, suffix)]


def test_uint8_rows_and_readers(tmp_path):
    res, run = traced(tmp_path, "uint8.default.x32")
    boots = in_window(run, "bootstrap")
    assert boots and sum(r.attrs["rows"] for r in boots) == run.spans.layers["bootstrap_raw"].rows
    assert len(boots) == run.spans.layers["bootstrap_raw"].calls
    assert {r.attrs["path"] for r in in_window(run, "blind_rotate")} == {"k1"}
    m = res["metrics"]
    for name in ("k1_host_us_per_step.uint", "pad_rows_pct.uint", "setup_port_s"):
        assert m[name]["value"] > 0, name
    levels = in_window(run, "evaluate.level")
    pad = 100 * sum(r.attrs["pad_rows"] for r in levels) / sum(r.attrs["rows"] for r in levels)
    assert m["pad_rows_pct.uint"]["value"] == pytest.approx(pad) and 0 < pad < 100
    assert m["setup_port_s"]["value"] < run.setup_s


def test_radix_rows_labels_and_readers(tmp_path):
    from fhebench.metrics import _program

    res, run = traced(tmp_path, "radix.pbs.x256")
    pbs = in_window(run, "pbs")
    layers = run.spans.layers
    assert pbs and sum(r.attrs["rows"] for r in pbs) == sum(
        layers[k].rows for k in ("pbs", "pbs_many") if k in layers)
    labels = Counter(label for _, _, label in run.trace.spans["blind_rotate"])
    mine = Counter(f"blind_rotate#{r.attrs['rows']}#{r.attrs['tv_rows']}"
                   for _, _, r in _program.profiled(run, "blind_rotate"))
    assert labels and mine == labels
    rots = in_window(run, "blind_rotate")
    assert sum(r.attrs["rows"] for r in rots) == layers["blind_rotate"].rows
    assert "bitcircuit_share_pct.radix" not in res["metrics"]  # no device operation
    assert res["metrics"]["setup_port_s"]["value"] > 0


def test_expr_readers(tmp_path):
    res, run = traced(tmp_path, "expr.default.b1")
    m = res["metrics"]
    assert m["plan_ms_per_expr.expr"]["value"] > 0 and m["setup_port_s"]["value"] > 0
    for name in ("keyswitch_idle_ms_per_level.expr", "rotate_device_us_per_level.expr",
                 "launches_per_level.expr"):
        assert name not in m and reader(name).read(run) is None
    assert {r.attrs["path"] for r in in_window(run, "blind_rotate")} == {"k3"}
    assert len(in_window(run, "evaluate.plan")) == len(run.records)


def made_up_run(monkeypatch, offset):
    """Nine requests of one block each, 0.5 s apart, profiled from the
    second, with the program's spans of the second and third request.  On
    the trace's clock a request starts ``offset`` us after the host clock's
    start, give or take 0.4 us, the first profiled request 24 us later and
    one 30 us earlier (as the chip's runs read).  Each of the two holds a
    ``bootstrap`` whose ``blind_rotate`` (K3) launches two kernels and whose
    ``key_switch`` launches one, after a 250 us idle gap."""
    from fhebench.metrics import _program

    host = [100.0 + 0.5 * k for k in range(9)]  # request starts, seconds
    jitter = [0.0, 24.0, -0.3, 0.1, -30.0, -0.2, 0.3, 0.0, -0.4]

    def to_trace(us):  # the trace's clock at host microseconds ``us``
        return us + offset

    req = [(to_trace(h * 1e6) + j, to_trace(h * 1e6) + j + 5000.0, "request")
           for h, j in zip(host, jitter)][1:]
    recs, ops, launches, ident = [], [], {}, iter(range(1, 100))
    corr = iter(range(1, 100))

    def span(name, a, b, parent, **attrs):
        rid = next(ident)
        recs.append(trace.Record(rid, parent, parent or rid, name, int(a * 1e3), int(b * 1e3),
                                 attrs))
        return rid

    def op(at, s, e):
        c = next(corr)
        launches[c] = to_trace(at)
        ops.append((to_trace(s), to_trace(e), "k", c))

    for h in host[1:3]:
        t = h * 1e6  # host microseconds
        boot = span("bootstrap", t + 10, t + 900, None, rows=1)
        span("blind_rotate", t + 20, t + 460, boot, rows=1, tv_rows=1, path="k3", steps=1)
        op(t + 30, t + 40, t + 140)  # 100 us
        op(t + 50, t + 150, t + 450)  # 300 us
        span("key_switch", t + 470, t + 800, boot, rows=1)
        op(t + 610, t + 700, t + 720)  # 20 us, after a 250 us gap in the key switch
    tr = _trace.Trace(req[0][0] - 50, req[-1][1] + 5, sorted(ops), launches, {"request": req})
    run = SimpleNamespace(trace=tr, traffic=SimpleNamespace(block=1),
                          records=[harness.Record(None, h, h + 0.005) for h in host],
                          start=host[0], setup_s=1.0, params=None)
    monkeypatch.setattr(_program, "tracer", SimpleNamespace(records=lambda: list(recs)))
    return run


@pytest.mark.parametrize("offset", [1.7e15 + 123.4567, -2.5e6])
def test_the_clock_map_and_the_device_readers_on_a_made_up_trace(monkeypatch, offset):
    from fhebench.metrics import _program

    run = made_up_run(monkeypatch, offset)
    # float microseconds: 0.25 apart at 1.7e15
    assert abs(_program.offset_us(run) - offset) < 1.0
    offs = [o - offset for o in _program.offsets_us(run)]
    assert offs == pytest.approx([24.0, -0.3, 0.1, -30.0, -0.2, 0.3, 0.0, -0.4], abs=0.5)
    assert reader("launches_per_level.expr").read(run) == 3.0
    assert reader("rotate_device_us_per_level.expr").read(run) == pytest.approx(400.0, abs=0.01)
    idle = _program.idle_by_span(run)
    assert idle["key_switch"] == pytest.approx(2 * 250e-6, abs=1e-8)
    assert reader("keyswitch_idle_ms_per_level.expr").read(run) == pytest.approx(0.25, abs=1e-5)
    assert reader("bitcircuit_share_pct.radix").read(run) == pytest.approx(
        100.0, abs=0.01)  # every busy microsecond is inside the bootstraps


def test_with_no_tracer_in_the_program(tmp_path, monkeypatch):
    """A program without ``utils/trace.py``: the import finds nothing, the
    traced run's line leaves the eight metrics out, and every reader, asked
    directly, returns None."""
    import rustfhe_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "rustfhe_tpu_torch.utils.trace", None)
    monkeypatch.delattr(rustfhe_tpu_torch.utils, "trace")
    spec = importlib.util.spec_from_file_location(
        "fhebench.metrics._program", harness.ROOT / "metrics" / "_program.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.tracer is None
    monkeypatch.setitem(sys.modules, "fhebench.metrics._program", mod)
    monkeypatch.setattr(fhebench.metrics, "_program", mod, raising=False)
    res, run = traced(tmp_path, "expr.default.b1")
    assert not trace.enabled() and not set(NEW) & set(res["metrics"])
    for name in NEW:
        assert reader(name).read(run) is None, name
