"""The ports of the JAX package's example scripts run end to end on the CPU
(``RUSTFHE_FORCE_CPU=1``, no key cache), each to its closing line, as
tests/test_torch_radix.py runs ``radix_bench``.  A script with no switch
for small parameters gets its DEFAULT_PARAMS patched to TEST_PARAMS (or,
for the adder's latency path, to PBS_TEST_PARAMS, where the single-launch
rotation K3 takes small levels); their numbers mean nothing here.
"""

import pytest

from rustfhe_tpu_torch import params
from rustfhe_tpu_torch.examples import (adder_bench, client_server, encrypted_compare,
                                        encrypted_ints, homnand_bench, lut_eval)


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("RUSTFHE_FORCE_CPU", "1")
    monkeypatch.setenv("KEYFILE", "")
    monkeypatch.delenv("RUSTFHE_ENGINE", raising=False)


def test_client_server(capsys):
    client_server.main()  # TEST_PARAMS on the CPU, as the JAX script picks by backend
    out = capsys.readouterr().out
    assert "params: n=16, N=64 (cpu" in out
    assert "public key: 34 zero-encryptions" in out
    assert "alice's upload: 6 words seeded vs 68 full (11x smaller)" in out
    assert out.rstrip().endswith("both decode correctly; server never saw a secret key"), out


def test_homnand_bench(monkeypatch, capsys):
    monkeypatch.setattr(homnand_bench, "P", params.TEST_PARAMS)
    homnand_bench.main(["2"])
    out = capsys.readouterr().out
    assert "engine: matmul on cpu" in out
    for gate in ("nand", "and", "or", "xor"):
        assert f"{gate:5s} OK " in out and "(8 gates," in out, gate
    assert out.rstrip().splitlines()[-1].startswith("not   OK "), out


@pytest.mark.parametrize("preset, on_k3", [("TEST_PARAMS", 0), ("PBS_TEST_PARAMS", 7)])
def test_adder_bench(monkeypatch, capsys, preset, on_k3):
    """The latency rule: 4 additions take a latency context; on a K1-K3
    key (PBS_TEST_PARAMS, "cmux_k") its 7 levels of <= 64 lanes run K3, on
    a generic key (TEST_PARAMS, "matmul") the step loop."""
    monkeypatch.setattr(adder_bench, "DEFAULT_PARAMS", getattr(params, preset))
    adder_bench.main(["4", "4"])
    out = capsys.readouterr().out
    assert "4-bit adder: 17 gates, depth 7" in out and "latency_mode=True" in out
    assert "OK: 4 additions" in out
    assert out.rstrip().splitlines()[-1].startswith(
        f"blind rotations: 7 levels of 4-32 lanes; {on_k3} on K3 (one launch each), "
        f"{7 - on_k3} on the step loop"), out


def test_encrypted_compare(capsys):
    encrypted_compare.main(["6", "4", "test"])
    out = capsys.readouterr().out
    assert "# comparator: 6 encrypted comparisons correct" in out
    assert "# subtractor: 6 encrypted subtractions correct" in out
    assert out.rstrip().endswith("ok"), out


def test_encrypted_ints(capsys):
    encrypted_ints.main(["4", "3", "test"])
    out = capsys.readouterr().out
    for tag in ("a + b", "a * b", "a < b", "min", "a // b", "a % b", "abs(s)"):
        assert f"{tag:>10}: 4/4 correct" in out, tag
    assert out.rstrip().endswith("# all integer ops decode correctly"), out


def test_lut_eval(capsys):
    lut_eval.main(["--params", "test", "--batch", "16"])
    out = capsys.readouterr().out
    assert "x^2 mod 4: 16 lookups correct" in out
    assert "multi-LUT: 16 distinct random functions correct" in out
    assert "chained g(f(x)): 16 correct" in out
    assert "manyLUT table 1: 16/16 correct" in out
    assert out.rstrip().endswith("OK"), out


def test_lut_eval_refuses_an_unsound_space(capsys):
    with pytest.raises(SystemExit) as e:
        lut_eval.main(["--params", "test", "--space", "64", "--batch", "4"])
    assert e.value.code == 1
    assert "[UNSOUND — refusing]" in capsys.readouterr().out
