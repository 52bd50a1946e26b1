"""The port's tracer (``utils/trace.py``): off by default and free there,
and when on, the span tree of the table in its docstring, with rows and
padding rows that equal the plan's, one root per call into the port, the
rotation's path and step count, a lookup's preparation and extraction, the
cap, and the spans on a profiler's trace."""

import json
import subprocess
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from rustfhe_tpu_torch import TFHE, keys, pbs
from rustfhe_tpu_torch.apps import circuits
from rustfhe_tpu_torch.params import FAST_PARAMS, PBS_TEST_PARAMS, TEST_PARAMS
from rustfhe_tpu_torch.utils import timing, trace


@pytest.fixture(autouse=True)
def tracer_off():
    """Every case starts from an empty list and leaves the tracer off."""
    trace.enable(False)
    trace.clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    trace.enable(False)
    trace.clear()
    torch.set_num_threads(threads)


def by_name(recs, name):
    return [r for r in recs if r.name == name]


def test_off_by_default_in_a_fresh_interpreter():
    code = ("from rustfhe_tpu_torch.utils import trace\n"
            "with trace.span('bootstrap', rows=3) as s:\n"
            "    pass\n"
            "print(trace.enabled(), s is trace.OFF, len(trace.records()), trace.dropped())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.split() == ["False", "True", "0", "0"]


def test_off_returns_the_shared_no_op_and_allocates_nothing():
    assert not trace.enabled()
    with trace.span("bootstrap", rows=4) as s:
        s.set(rows=5)
    assert s is trace.OFF and trace.span("key_switch") is trace.OFF
    assert trace.records() == [] and trace.dropped() == 0

    def spans(n):
        for i in range(n):
            with trace.span("evaluate.level", rows=i, pad_rows=0):
                pass

    spans(100)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        spans(20000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, trace.__file__)]
    grown = after.filter_traces(only).compare_to(before.filter_traces(only), "filename")
    assert sum(d.size_diff for d in grown) == 0 and trace.records() == []


def test_an_add_and_a_pbs_many_make_the_span_tree(monkeypatch):
    plans, level_plan = [], circuits._level_plan

    def spy(circuit, fixed_width):
        out = level_plan(circuit, fixed_width)
        plans.append((out[0], out[1]))
        return out

    monkeypatch.setattr(circuits, "_level_plan", spy)
    ctx = TFHE.new(3, TEST_PARAMS, device="cpu", engine_name="cmux_k")
    va, vb = np.array([1, 2, 3], np.uint64), np.array([3, 3, 0], np.uint64)
    a, b = ctx.encrypt_uint(va, 2), ctx.encrypt_uint(vb, 2)
    trace.enable()
    total = (a + b).decrypt()
    trace.enable(False)
    assert total.tolist() == ((va + vb) % 4).tolist()

    recs = trace.records()
    ids = {r.id: r for r in recs}
    (ev,) = by_name(recs, "evaluate")
    (plan,) = by_name(recs, "evaluate.plan")
    levels = sorted(by_name(recs, "evaluate.level"), key=lambda r: r.t0_ns)
    (widths, counts), = plans
    assert ev.parent is None and {r.root for r in recs} == {ev.id}
    assert ev.attrs == {"lanes": 3, "levels": len(widths)}
    assert plan.parent == ev.id and plan.attrs == {"gates": sum(counts)}
    assert [lv.attrs for lv in levels] == [
        {"rows": w * 3, "pad_rows": (w - k) * 3} for w, k in zip(widths, counts)]
    assert all(lv.parent == ev.id for lv in levels)
    boots = sorted(by_name(recs, "bootstrap"), key=lambda r: r.t0_ns)
    assert [ids[bt.parent] for bt in boots] == levels
    assert [bt.attrs["rows"] for bt in boots] == [lv.attrs["rows"] for lv in levels]
    for name in ("blind_rotate", "key_switch"):
        got = sorted(by_name(recs, name), key=lambda r: r.t0_ns)
        assert [ids[r.parent] for r in got] == boots
        assert [r.attrs["rows"] for r in got] == [bt.attrs["rows"] for bt in boots]
    for r in by_name(recs, "blind_rotate"):
        assert r.attrs == {"rows": r.attrs["rows"], "tv_rows": 1, "path": "k1",
                           "steps": TEST_PARAMS.n, "calls": 1, "product": "schoolbook"}
    for r in recs:
        assert r.t0_ns <= r.t1_ns
        if r.parent is not None:
            p = ids[r.parent]
            assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns

    ctx = TFHE.new(5, PBS_TEST_PARAMS, device="cpu")
    ct = ctx.encrypt_int(np.array([0, 1, 2, 3, 1]), 4)
    tables = np.array([[1, 2, 3, 0], [3, 2, 1, 0]])
    trace.clear()
    trace.enable()
    for _ in range(2):
        pbs.pbs_many(ctx.ck, ct, tables, space=4, params=ctx.params, unsafe=True)
    recs = trace.records()
    calls = by_name(recs, "pbs")
    assert len(calls) == 2 and all(c.parent is None for c in calls)
    assert [c.attrs for c in calls] == [{"rows": 5, "tables": 2}] * 2
    for c in calls:
        inner = [r for r in recs if r.root == c.id and r is not c]
        assert sorted(r.name for r in inner) == ["blind_rotate", "extract", "key_switch",
                                                 "pbs.prepare"]
        assert all(r.parent == c.id for r in inner)
        (rot,) = by_name(inner, "blind_rotate")
        assert rot.attrs["rows"] == 5 and rot.attrs["tv_rows"] == 1
        assert by_name(inner, "key_switch")[0].attrs == {"rows": 10}


@pytest.fixture(scope="module")
def pbs_ctx():
    return TFHE.new(13, PBS_TEST_PARAMS, device="cpu")


def lookup(ctx, t):
    """Six rows through a table per row: ``pbs.pbs`` at t = 1, else
    ``pbs.pbs_many``; the outputs decrypted, and the tables' entries they
    must equal."""
    x = np.array([0, 3, 1, 2, 3, 0])
    tables = np.random.RandomState(14).randint(0, 4, size=(6, t, 4))
    ct = ctx.encrypt_int(x, 4)
    if t == 1:
        out = pbs.pbs(ctx.ck, ct, tables[:, 0], space=4, params=ctx.params)[:, None]
    else:
        out = pbs.pbs_many(ctx.ck, ct, tables, space=4, params=ctx.params, unsafe=True)
    return ctx.decrypt_int(out, 4).numpy(), tables[np.arange(6), :, x]


@pytest.mark.parametrize("t", [1, 2])
def test_a_lookup_records_its_preparation_and_extraction(pbs_ctx, t):
    trace.enable()
    got, want = lookup(pbs_ctx, t)
    trace.enable(False)
    np.testing.assert_array_equal(got, want)
    recs = trace.records()
    (call,) = by_name(recs, "pbs")
    (prep,) = by_name(recs, "pbs.prepare")
    (rot,) = by_name(recs, "blind_rotate")
    (ext,) = by_name(recs, "extract")
    assert call.attrs == {"rows": 6, "tables": t}
    assert prep.attrs == {"rows": 6, "tv_rows": 6, "t": t}
    assert ext.attrs == {"rows": 6, "t": t}
    assert rot.attrs["rows"] == rot.attrs["tv_rows"] == 6
    assert prep.parent == rot.parent == ext.parent == call.id
    assert prep.t1_ns <= rot.t0_ns and rot.t1_ns <= ext.t0_ns


def test_a_gate_bootstrap_records_its_extraction():
    ctx = TFHE.new(15, TEST_PARAMS, device="cpu", engine_name="cmux_k")
    x, y = ctx.encrypt([0, 1, 0, 1]), ctx.encrypt([0, 0, 1, 1])
    trace.enable()
    out = ctx.nand(x, y)
    trace.enable(False)
    assert ctx.decrypt(out).tolist() == [1, 1, 1, 0]
    recs = trace.records()
    (boot,) = by_name(recs, "bootstrap")
    (rot,) = by_name(recs, "blind_rotate")
    (ext,) = by_name(recs, "extract")
    assert ext.attrs == {"rows": 4, "t": 1} and ext.parent == boot.id
    assert rot.t1_ns <= ext.t0_ns and not by_name(recs, "pbs.prepare")


@pytest.mark.parametrize("t", [1, 2])
def test_with_the_tracer_off_a_lookup_records_nothing(pbs_ctx, t):
    got, want = lookup(pbs_ctx, t)
    np.testing.assert_array_equal(got, want)
    assert trace.records() == [] and trace.dropped() == 0


@pytest.mark.parametrize("case,path,steps,calls", [
    ("standard", "k1", TEST_PARAMS.n, 1),
    ("latency", "k3", 1, 1),
    ("generic", "generic", TEST_PARAMS.n, TEST_PARAMS.n),
    ("hybrid", "hybrid", TEST_PARAMS.n, TEST_PARAMS.n),
    ("limb", "limb", 16, 16),
])
def test_blind_rotate_names_its_path_and_steps(case, path, steps, calls):
    p = FAST_PARAMS.replace(n=16, N=128) if case == "limb" else TEST_PARAMS
    engine = {"generic": "matmul", "limb": "limb"}.get(case, "cmux_k")
    ctx = TFHE.new(11, p, device="cpu", latency_mode=case == "latency", engine_name=engine)
    if case == "hybrid":
        ctx.ck = keys.cloud_key_hybrid(ctx.ck, p)
    x, y = ctx.encrypt([0, 1, 0, 1]), ctx.encrypt([0, 0, 1, 1])
    trace.enable()
    out = ctx.nand(x, y)
    trace.enable(False)
    assert ctx.decrypt(out).tolist() == [1, 1, 1, 0]
    recs = trace.records()
    (rot,) = by_name(recs, "blind_rotate")
    product = {"product": "schoolbook"} if path == "k1" else {}  # K1's alone, at 4 rows
    assert rot.attrs == {"rows": 4, "tv_rows": 1, "path": path, "steps": steps, "calls": calls,
                         **product}
    assert not [r for r in recs if r.parent == rot.id]  # no span on a step
    assert [r.name for r in recs if r.parent is None] == ["bootstrap"]


def test_clear_and_the_cap(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    trace.enable()
    for i in range(5):
        with trace.span("pbs", rows=i):
            pass
    assert [r.attrs["rows"] for r in trace.records()] == [0, 1, 2]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0
    with trace.span("pbs", rows=9):
        pass
    assert len(trace.records()) == 1


def test_each_thread_keeps_its_own_stack():
    trace.enable()
    go = threading.Barrier(2)

    def work(tag):
        with trace.span("evaluate", lanes=tag):
            go.wait()
            with trace.span("evaluate.level", rows=tag, pad_rows=0):
                go.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = trace.records()
    for tag in (1, 2):
        (ev,) = [r for r in recs if r.name == "evaluate" and r.attrs["lanes"] == tag]
        (lv,) = [r for r in recs if r.name == "evaluate.level" and r.attrs["rows"] == tag]
        assert ev.parent is None and ev.root == ev.id and lv.parent == lv.root == ev.id


def test_spans_appear_on_the_profilers_trace(tmp_path):
    trace.enable()
    with timing.profile_trace(str(tmp_path)):
        with trace.span("evaluate", lanes=1):
            with trace.span("bootstrap", rows=1):
                torch.ones(8).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"rustfhe.evaluate", "rustfhe.bootstrap"} <= names
    assert [r.name for r in trace.records()] == ["bootstrap", "evaluate"]
