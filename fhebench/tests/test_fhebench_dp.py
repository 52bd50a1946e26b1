"""The four-card cell ``gates.default.dp4`` on the CPU: its files, and a
stand-in of it (n = 16, N = 256, 8 lanes on a (4, 1) mesh of four gloo
ranks: the harness's process and three peers that ``traffic/gates_dp.py``
starts).

* the configuration, mix and cell files parse and agree with
  ``BENCHMARK.json``;
* a sound run is correct and names the devices its ranks ran on, its
  traced run reads the bytes that cross cards,
  and no peer is left behind;
* the control and every fault on rank 0's block, and a fault planted in a
  peer's block, are not correct;
* an error in rank 0 and a peer killed in the window fail the run in a
  bounded time and leave no peer behind;
* neither rank 0 nor a peer imports jax, jaxlib, flax or the JAX package.
"""

from __future__ import annotations

import time

import pytest

from fhebench import checks, harness
from fhebench.tests import standin
from fhebench.tests.test_fhebench_correct import answer_altered, half_batch, step_unchanged
from fhebench.tests.test_fhebench_imports import top_level_after

CELL = "gates.default.dp4"
BENCH = harness.load_json(harness.BENCHMARK)
ENTRY = next(w for w in BENCH["workloads"] if w["name"] == CELL)


def make_root(tmp, peer_module: str | None = None):
    """The stand-in root with the dp4 stand-in beside the others; with
    ``peer_module`` the generator's copy starts that module as its peers."""
    root, bench = standin.make_root(tmp)
    standin.write(root / "configs" / "tiny-dp4.json",
                  {**standin.TINY, "mesh": {"data": 4, "model": 1}})
    mix = harness.load_json(harness.ROOT / "traffic" / f"{ENTRY['traffic']}.json")
    standin.write(root / "traffic" / "gates_dp_tiny.json",
                  {**mix, "lanes": 8, "pool": 2, "check": {"requests": 6, "lanes": 4}})
    settings = harness.load_json(harness.ROOT / "workloads" / f"{CELL}.json")
    standin.write(root / "workloads" / f"{CELL}.json",
                  {**settings, "config": "tiny-dp4", "traffic": "gates_dp_tiny",
                   "profile_seconds": 0.2})
    if peer_module is not None:
        src = root / "traffic" / "gates_dp.py"
        text = src.read_text()
        real = 'PEER = ["-m", "fhebench.traffic.gates_dp"]'
        assert real in text
        src.write_text(text.replace(real, f'PEER = ["-m", "{peer_module}"]'))
    entry = {**ENTRY, "config": "tiny-dp4", "traffic": "gates_dp_tiny"}
    return root, {**bench, "workloads": bench["workloads"] + [entry]}


def run(tmp, seed=2 ** 33 + 22, trace=False, tamper=None, peer_module=None):
    """A stand-in run (its warm-up and one block) and the PIDs of its peers."""
    root, bench = make_root(tmp, peer_module)
    pids = []

    def keep(run, patches):
        pids.extend(q.pid for q in run.traffic.peers.procs)
        if tamper is not None:
            tamper(run, patches)

    try:
        return harness.run_cell(CELL, seed, 0.0, trace, "cpu", bench=bench, root=root,
                                tamper=keep, log=lambda m: None), pids
    finally:
        assert len(pids) == 3
        assert not [p for p in pids if alive(p)]


def alive(pid: int) -> bool:
    """Whether ``pid`` is a live process (a zombie is not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_the_files():
    cfg = harness.load_json(harness.ROOT / "configs" / f"{ENTRY['config']}.json")
    base = harness.load_json(harness.ROOT / "configs" / "default-n635-N1024.json")
    from fhebench.reference.tfhe import Params

    assert {k: cfg[k] for k in Params.__dataclass_fields__} == {
        k: base[k] for k in Params.__dataclass_fields__}
    assert cfg["mesh"] == {"data": 4, "model": 1} and cfg["reduced"] == []
    assert cfg["assumed"] and cfg["deployment"] and cfg["guarantees"]
    mix = harness.load_json(harness.ROOT / "traffic" / f"{ENTRY['traffic']}.json")
    assert mix["generator"] == "gates_dp" and mix["lanes"] == 65536 and mix["pool"] == 8
    assert sorted(mix["gates"]) == sorted(["nand", "and", "or", "xor", "not", "mux"])
    assert mix["check"] == {"requests": 6, "lanes": 64}
    data = cfg["mesh"]["data"]
    assert mix["lanes"] % data == 0 and mix["check"]["lanes"] % data == 0
    cell = harness.load_json(harness.ROOT / "workloads" / f"{CELL}.json")
    assert cell["chips"] == ENTRY["chips"] == cfg["mesh"]["data"] * cfg["mesh"]["model"]
    assert cell["latency_mode"] is False and cell["profile_seconds"] == 5
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    names = [m["name"] for m in harness.metric_list(BENCH, CELL, True)]
    assert {"collective_share_pct.dp4", "collective_bytes_per_gate.dp4",
            "rotate_roofline.dp4", "device_idle_pct.dp4"} <= set(names)
    assert [m["name"] for m in harness.metric_list(BENCH, CELL, False)] == [
        "gates_per_s", "setup_s"]


def test_a_sound_run(tmp_path):
    res, _ = run(tmp_path)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 6 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu" and res["device"]["count"] == 1  # one host's CPU


def card(index, kind="NVIDIA H100 80GB HBM3", host="h"):
    return {"host": host, "type": "cuda", "kind": kind, "index": index, "uuid": f"GPU-{index}"}


@pytest.mark.parametrize("infos, count", [
    ([card(0), card(1), card(2), card(3)], 4),
    ([card(0), card(1)], 2),
    ([card(0), card(0)], 1),
    ([card(0), card(0, host="g")], 2),
    ([{"host": "h", "type": "cpu", "kind": "cpu"}] * 4, 1),
], ids=["four", "two", "one-shared", "two-hosts", "cpu"])
def test_the_line_counts_each_card_once(infos, count):
    from fhebench.traffic import gates_dp

    assert gates_dp.count_cards(infos) == count


def test_ranks_on_cards_of_two_kinds_are_refused():
    from fhebench.traffic import gates_dp

    with pytest.raises(RuntimeError, match="2 kinds"):
        gates_dp.count_cards([card(0), card(1, kind="NVIDIA A100")])


def test_only_a_generator_with_cards_sets_the_count():
    from types import SimpleNamespace

    from fhebench.traffic import gates_dp

    assert getattr(harness._run, "reports_cards", False)
    wrapped = gates_dp._reporting_cards(lambda run: {"device": {"count": 1}})
    assert wrapped(SimpleNamespace(traffic=SimpleNamespace(cards=4)))["device"]["count"] == 4
    assert wrapped(SimpleNamespace(traffic=SimpleNamespace()))["device"]["count"] == 1


def test_a_traced_run_reads_the_bytes_that_cross_cards(tmp_path):
    """1.333 passes a lane (MUX: two rows, then one), 3/4 of each output
    row of (n + 1) x 4 = 68 bytes: 68 bytes a gate.  No device operation on
    the CPU, so the device readers read nothing."""
    res, _ = run(tmp_path, trace=True)
    m = res["metrics"]
    assert res["correct"] and m["collective_bytes_per_gate.dp4"]["value"] == 68.0
    for name in ("collective_share_pct.dp4", "rotate_roofline.dp4", "device_idle_pct.dp4"):
        assert name not in m
    assert m["setup_port_s"]["value"] > 0


@pytest.mark.parametrize("fault", [checks.control, step_unchanged, half_batch, answer_altered],
                         ids=lambda f: f.__name__)
def test_faults_on_rank_0_are_not_correct(tmp_path, fault):
    res, _ = run(tmp_path, seed=4, tamper=fault)
    assert not res["correct"], res["checks"]


def test_a_fault_in_a_peers_block_is_not_correct(tmp_path):
    res, _ = run(tmp_path, seed=5, peer_module="fhebench.tests.dp_faulty_peer")
    assert not res["correct"] and res["checks"]["wrong_outputs"]["value"] > 0, res["checks"]


def test_an_error_in_rank_0_leaves_no_peer(tmp_path):
    """An error in rank 0's request path ends the peers at once."""
    from rustfhe_tpu_torch import gates

    def fail_in_the_window(run, patches):
        calls, honest = [], gates.gate_circuit

        def failing(*args, **kwargs):
            calls.append(args[0])
            if len(calls) == 5:
                raise RuntimeError("planted")
            return honest(*args, **kwargs)

        patches.replace("rustfhe_tpu_torch.gates:gate_circuit", lambda fn: failing)

    with pytest.raises(RuntimeError, match="planted"):
        run(tmp_path, tamper=fail_in_the_window)


RANK0 = """
import os, signal, sys
from pathlib import Path
from fhebench import harness
from fhebench.tests import test_fhebench_dp as t
how = sys.argv[1]
root, bench = t.make_root(Path(sys.argv[2]))
def end(run, patches):
    print(" ".join(str(q.pid) for q in run.traffic.peers.procs), flush=True)
    send, calls = run.traffic.send, []
    def ending(req):
        calls.append(req)
        if len(calls) == 5:
            if how == "error":
                raise RuntimeError("planted")
            os.kill(os.getpid(), getattr(signal, how.upper()))
        return send(req)
    run.traffic.send = ending
harness.run_cell(t.CELL, 9, 0.0, False, "cpu", bench=bench, root=root, tamper=end,
                 log=lambda m: None)
"""


@pytest.mark.parametrize("how", ["error", "sigterm", "sigkill"])
def test_rank_0_ending_between_requests_leaves_no_peer(tmp_path, how):
    """Rank 0 as a process of its own ends in its window outside the
    request path: by an error (the peers are ended at exit), by SIGTERM
    (the same, through the handler) or by SIGKILL (each peer sees its
    parent gone)."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", RANK0, how, str(tmp_path)],
                         cwd=harness.ROOT.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    pids = [int(p) for p in out.stdout.split()]
    assert len(pids) == 3, out.stderr[-3000:]
    deadline = time.monotonic() + 20
    while [p for p in pids if alive(p)] and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not [p for p in pids if alive(p)]


def test_a_peer_killed_in_the_window_fails_the_run_in_time(tmp_path):
    """Rank 1 is killed after the window's first header: rank 0's gather
    fails (gloo sees the closed connection) well inside the collective
    timeout, and the other peers are ended."""
    from rustfhe_tpu_torch.parallel import multihost

    def kill_a_peer(run, patches):
        peers, told = run.traffic.peers, []
        tell = peers.tell

        def telling(line):
            tell(line)
            told.append(line)
            if len(told) == 4:  # three warm-up requests, then the window's first
                peers.procs[0].kill()
                peers.procs[0].wait()

        peers.tell = telling

    t0 = time.monotonic()
    with pytest.raises(Exception):
        run(tmp_path, tamper=kill_a_peer)
    assert time.monotonic() - t0 < multihost.TIMEOUT.total_seconds() + 30


def test_no_rank_imports_jax(tmp_path):
    """A whole stand-in run in a fresh interpreter: rank 0's modules hold
    none of them, and each peer checks its own at exit (a peer that
    imported one exits 3, which fails the run)."""
    code = ("from pathlib import Path\nfrom fhebench.tests import test_fhebench_dp as t\n"
            f"res, _ = t.run(Path({str(tmp_path)!r}))\nassert res['correct']\n")
    assert not top_level_after(code) & set(harness.FORBIDDEN)
