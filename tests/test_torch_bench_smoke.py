"""Smoke test of the port's bench (``python3 -m rustfhe_tpu_torch.bench``).

The whole harness runs in-process at TEST_PARAMS on the CPU (every
correctness check: the mixed truth-table batch, the MUX second pass, the
8-bit adder through the level-fused evaluator, the timed NAND batch) and
its one-line JSON contract is checked, in the manner of
``tests/test_bench_smoke.py`` for the JAX package's ``bench.py``.  The
number it prints here is a CPU run's and means nothing for the card.
"""

import json

import pytest
import torch

from rustfhe_tpu_torch import bench


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one intra-op thread each.  Under
    parallel test workers, torch's idle OpenMP threads spin on the cores
    the other workers need (4x slower with six busy processes on an 8-core
    CPU host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv("RUSTFHE_FORCE_CPU", "1")
    monkeypatch.setenv("BENCH_PARAMS", "test")
    monkeypatch.setenv("BENCH_BATCH", "64")
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.setenv("BENCH_GATES", "all")
    for knob in ("BENCH_HYBRID", "BENCH_SHARDED"):
        monkeypatch.delenv(knob, raising=False)
    return monkeypatch


def test_port_bench_harness_end_to_end(cpu_env, capsys):
    bench.main()
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()
    assert len(out) == 1, f"the bench must print exactly one stdout line, got {out}"
    rec = json.loads(out[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "homnand_bootstraps_per_sec_single_gpu"
    assert rec["unit"] == "gates/s"
    assert rec["value"] > 0
    # vs_baseline is rounded to one decimal, as in the JAX bench
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / (1e9 / 30_558_481.0), abs=0.05)
    for check in ("nand", "and", "or", "xor", "not", "mux", "adder8", "nand-timed"):
        assert f"# correctness[{check}]" in captured.err, check


@pytest.mark.parametrize("knob,item", [("BENCH_SHARDED", "item J"), ("BENCH_HYBRID", "item I")])
def test_port_bench_refuses_the_modes_it_lacks(cpu_env, capsys, knob, item):
    """The two modes the port lacked (ROADMAP items J, the sharded path,
    and I, hybrid keys) are ported: each runs, keeps the one JSON line,
    and logs its check (the sharded output equal word for word to the
    unsharded one; at TEST_PARAMS the "matmul" engine has no hybrid form,
    and the bench says so)."""
    cpu_env.setenv(knob, "1")
    bench.main()
    captured = capsys.readouterr()
    assert len(captured.out.strip().splitlines()) == 1
    want = {"item J": "# correctness[sharded]: equal word for word",
            "item I": "# engine matmul has no hybrid form"}[item]
    assert want in captured.err


def test_port_bench_runs_on_the_card_unless_told_otherwise(cpu_env):
    cpu_env.delenv("RUSTFHE_FORCE_CPU")
    if torch.cuda.is_available():
        assert bench.bench_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main()
