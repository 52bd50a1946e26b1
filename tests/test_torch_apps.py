"""The port's nander console, its fused evaluator and the circuit IR,
against the JAX package's.

Parser, AST, evaluation and the circuit passes are plain Python in both
packages and must agree exactly.  ``FusedEvaluator``'s wire file must equal
JAX's word for word after every level (tolerance zero): the keys are the
JAX package's raw keys carried across with ``keys.from_jax_keys``, and the
leaves are trivial ciphertexts, so the whole evaluation is deterministic.
The console must print the same ``res:`` and ``parse error:`` lines as the
JAX console on the same input.
"""

import dataclasses
import functools
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rustfhe_tpu import context as jcontext
from rustfhe_tpu import keys as jkeys
from rustfhe_tpu.apps import circuits as jcircuits
from rustfhe_tpu.apps import nander as jnander
from rustfhe_tpu.apps import replprog as jreplprog
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.params import TEST_PARAMS as J_TEST
from rustfhe_tpu_torch import TFHE, _u32, keys, params
from rustfhe_tpu_torch.apps import circuits, nander, replprog

# The expressions of tests/test_replprog.py.
EXPRS = [
    "1", "0", "!1", "!!0",
    "1 $ 0", "0 $ 0", "1 & 1", "1 | 0", "1 ^ 1",
    "(1 & 0) ^ !0",
    "1 & 1 & 0 | 1",
    "((1|0)&(1^1))$(0|1)",
    "!(1 & (0 | !1)) ^ (1 $ (0 ^ 1))",
]
BAD = ["", "(1", "2", "1&", "&1", "1)", "()", "1 & 2", "(1 & 0"]
WIDE = ["1 $ 0", "1 & 1", "0 | 0", "1 ^ 0", "0 $ 0", "1 & 0", "1 | 0", "1 ^ 1", "!0", "!1"]


def _tree(e):
    """An AST of either package as nested tuples of (class name, fields)."""
    if dataclasses.is_dataclass(e):
        return (type(e).__name__,) + tuple(_tree(getattr(e, f.name))
                                           for f in dataclasses.fields(e))
    return e


@pytest.mark.parametrize("text", EXPRS + ["1^1^1", "!1&1", " ( 1 & 0 ) ^ !0 ", "1$0$1"])
def test_parse_and_eval_match_jax(text):
    ast = nander.parse_logic_expr(text)
    jast = jnander.parse_logic_expr(text)
    assert _tree(ast) == _tree(jast)
    assert (nander.eval_logic_expr(nander.PlainLogic(), ast)
            == jnander.eval_logic_expr(jnander.PlainLogic(), jast))


@pytest.mark.parametrize("text", BAD)
def test_parse_errors_match_jax(text):
    with pytest.raises(nander.ParseError) as got:
        nander.parse_logic_expr(text)
    with pytest.raises(jnander.ParseError) as want:
        jnander.parse_logic_expr(text)
    assert str(got.value) == str(want.value)


def test_nand_only_defaults():
    class NandOnly(nander.Logip):
        def nand(self, lhs, rhs):
            return 1 - (lhs & rhs)

        def logic_true(self):
            return 1

        def logic_false(self):
            return 0

    p = NandOnly()
    for a in (0, 1):
        assert p.not_(a) == 1 - a
        for b in (0, 1):
            assert (p.and_(a, b), p.or_(a, b), p.xor(a, b)) == (a & b, a | b, a ^ b)


def _circuit_parts(c):
    return ([(g.op, tuple(g.inputs), g.output) for g in c.gates], list(c.outputs), c.n_inputs)


@pytest.mark.parametrize("batch", [[e] for e in EXPRS] + [EXPRS, WIDE])
def test_circuit_passes_match_jax(batch):
    circ, leaves = replprog.exprs_to_circuit([nander.parse_logic_expr(e) for e in batch])
    jcirc, jleaves = jreplprog.exprs_to_circuit([jnander.parse_logic_expr(e) for e in batch])
    assert leaves == jleaves
    assert _circuit_parts(circ) == _circuit_parts(jcirc)
    opt, jopt = circuits.optimize(circ), jcircuits.optimize(jcirc)
    assert _circuit_parts(opt) == _circuit_parts(jopt)
    for lower in ("lower", "lower_folded"):
        got = getattr(circuits, lower)(opt)
        want = getattr(jcircuits, lower)(jopt)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), lower
    if opt.gates:
        bits = np.array(leaves)
        assert np.array_equal(circuits.evaluate_plain(opt, bits), jcircuits.evaluate_plain(jopt, bits))
    # mux lowers to three primitives in both
    m = circuits.Circuit(n_inputs=3)
    m.outputs = [m.mux(0, 1, 2)]
    jm = jcircuits.Circuit(n_inputs=3)
    jm.outputs = [jm.mux(0, 1, 2)]
    for g, w in zip(circuits.lower_folded(m), jcircuits.lower_folded(jm)):
        assert np.array_equal(np.asarray(g), np.asarray(w))


# --------------------------------------------------------------------- #
# FusedEvaluator against JAX's, word for word after every level
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=1)
def _contexts():
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    jsk = jkeys.gen_secret_key(k1, J_TEST)
    bk_raw, ksk_raw = jkeys.gen_cloud_key_raw(k2, jsk, J_TEST, "matmul")
    m = get_engine("matmul")
    jck = jkeys.CloudKey(bk=m.prepare_trgsw(bk_raw, J_TEST), ksk=m.prepare_ksk(ksk_raw, J_TEST))
    jctx = jcontext.TFHE(jsk, jck, J_TEST, "matmul")
    sk, ck = keys.from_jax_keys(*(np.asarray(x) for x in (jsk.lv0, jsk.lv1, bk_raw, ksk_raw)),
                                params.TEST_PARAMS, "cpu")
    ctx = TFHE(sk, keys.cloud_key_latency(ck), params.TEST_PARAMS, "cpu")
    return ctx, jctx, jreplprog.FusedEvaluator(jctx), replprog.FusedEvaluator(ctx)


def _same(got, want):
    assert np.array_equal(_u32.to_numpy(got), np.asarray(want))


def _plans_equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _plans_equal(x, y)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_fused_wire_file_matches_jax_every_level():
    ctx, jctx, jfe, fe = _contexts()
    p = ctx.params
    nonce = np.random.RandomState(3).randint(0, 2**32, size=p.n, dtype=np.uint64).astype(np.uint32)
    # A pipelined batch of mixed depths: its plan runs every level interior.
    batch = ["1 & 1 & 0 | 1", "!(1 & (0 | !1)) ^ (1 $ (0 ^ 1))", "1 $ 0", "1"]
    plan = fe._plan_many([nander.parse_logic_expr(e) for e in batch])
    jplan = jfe._plan_many([jnander.parse_logic_expr(e) for e in batch])
    _plans_equal(plan[1:], jplan[1:])
    _, leaf_bits, plans, roots, roots_neg = plan
    assert len(plans) >= 3
    leaves = np.full(fe.max_wires, 2, np.uint32)
    leaves[: len(leaf_bits)] = leaf_bits
    ck, jck = ctx.ck, jctx.ck
    wires = fe._first_level(ck.bk, ck.ksk, leaves, nonce, *plans[0])
    jwires = jfe._first_level(jck.bk, jck.ksk, leaves, nonce, *plans[0])
    _same(wires, jwires)
    for lv in plans[1:]:
        wires = fe._level(ck.bk, ck.ksk, wires, *lv)
        jwires = jfe._level(jck.bk, jck.ksk, jwires, *lv)
        _same(wires, jwires)
    rootv = np.full(fe.width, fe.max_wires - 1, np.int32)
    rootv[: len(roots)] = roots
    bits = fe._decrypt_many(ctx.sk.lv0, wires, rootv)
    assert np.array_equal(bits.numpy(), np.asarray(jfe._decrypt_many(jctx.sk.lv0, jwires, rootv)))

    # One deep expression: its levels, then the final lv1 program.
    expr = "!(1 & (0 | !1)) ^ (1 $ (0 ^ 1))"
    plan = fe._plan(nander.parse_logic_expr(expr))
    _plans_equal(plan[1:], jfe._plan(jnander.parse_logic_expr(expr))[1:])
    _, leaf_bits, _, plans, (iab, coeff), root_neg = plan
    leaves = np.full(fe.max_wires, 2, np.uint32)
    leaves[: len(leaf_bits)] = leaf_bits
    wires = fe._first_level(ck.bk, ck.ksk, leaves, nonce, *plans[0])
    jwires = jfe._first_level(jck.bk, jck.ksk, leaves, nonce, *plans[0])
    _same(wires, jwires)
    for lv in plans[1:]:
        wires = fe._level(ck.bk, ck.ksk, wires, *lv)
        jwires = jfe._level(jck.bk, jck.ksk, jwires, *lv)
        _same(wires, jwires)
    bit = fe._final(ck.bk, ctx.sk.lv1, wires, iab, coeff)
    assert int(bit) == int(jfe._final(jck.bk, jctx.sk.lv1, jwires, iab, coeff))
    plain = nander.eval_logic_expr(nander.PlainLogic(), nander.parse_logic_expr(expr))
    assert int(bit) ^ root_neg == plain

    # A depth-1 expression: the single-gate program.
    plan = fe._plan(nander.parse_logic_expr("0 $ 0"))
    _, leaf_bits, _, plans, (iab, coeff), root_neg = plan
    assert not plans
    leaves = np.full(fe.max_wires, 2, np.uint32)
    leaves[: len(leaf_bits)] = leaf_bits
    bit = fe._single_gate(ck.bk, ctx.sk.lv1, leaves, nonce, iab, coeff)
    assert int(bit) == int(jfe._single_gate(jck.bk, jctx.sk.lv1, leaves, nonce, iab, coeff)) == 1


def test_fused_eval_matches_plain():
    ctx, _, _, fe = _contexts()
    plain = nander.PlainLogic()
    for e in EXPRS:
        ast = nander.parse_logic_expr(e)
        assert fe.fits(ast), e
        assert fe.eval_bit(ast) == nander.eval_logic_expr(plain, ast), e
    assert fe.eval_bit(nander.parse_logic_expr("1 $ 1"), _nonce=np.arange(ctx.params.n)) == 0
    for batch in (["1 $ 0", "1 & 1", "0 | 0", "1 ^ 0"], ["1", "!0", "(1 & 0) ^ !0"],
                  ["1 & 1 & 0 | 1", "((1|0)&(1^1))$(0|1)"], ["0", "1"]):
        asts = [nander.parse_logic_expr(e) for e in batch]
        assert fe.fits_many(asts), batch
        assert fe.eval_bits(asts) == [nander.eval_logic_expr(plain, a) for a in asts], batch


def test_fused_capacity_errors():
    ctx, _, _, _ = _contexts()
    narrow = replprog.FusedEvaluator(ctx, width=2, max_wires=16)
    wide = nander.parse_logic_expr("(1 & 0) ^ (0 | 1) ^ (1 & 1) ^ (0 | 0)")
    assert not narrow.fits(wide)
    with pytest.raises(ValueError, match="static capacities"):
        narrow.eval_bit(wide)
    four = replprog.FusedEvaluator(ctx, width=4)
    asts = [nander.parse_logic_expr("1 $ 0")] * 5
    assert not four.fits_many(asts)
    with pytest.raises(ValueError, match="capacities"):
        four.eval_bits(asts)


def test_fhe_logic_matches_plain():
    ctx, _, _, _ = _contexts()
    fhe = nander.FheLogic(ctx)
    for e in ["(1&0)^!0", "1$0$1", "!(1|0)", "1^1^1"]:
        ast = nander.parse_logic_expr(e)
        assert int(ctx.decrypt(nander.eval_logic_expr(fhe, ast))) == \
            nander.eval_logic_expr(nander.PlainLogic(), ast), e


# --------------------------------------------------------------------- #
# The console against JAX's console
# --------------------------------------------------------------------- #
def _answers(text):
    return [ln for ln in text.splitlines() if ln.startswith(("res: ", "parse error: "))]


def test_console_res_lines_match_jax():
    script = "\n".join(EXPRS + ["1 $ 0; 1 & 1; (1 & 0) ^ !0", "; ".join(WIDE), "1 & 2",
                                "(1 & 0", "1; 0; 1"]) + "\n"
    out, jout = io.StringIO(), io.StringIO()
    nander.nander_console(params.TEST_PARAMS, "cpu", io.StringIO(script), out, latency_mode=True,
                          engine_name="cmux_k")
    jnander.nander_console(params=J_TEST, engine_name="matmul", stdin=io.StringIO(script),
                           stdout=jout)
    got, want = _answers(out.getvalue()), _answers(jout.getvalue())
    assert len(got) == len(EXPRS) + 5
    assert got == want
    assert "res: 1 1 0 1 1 0 1 0 1 0" in got  # the line wider than the CPU's 8 lanes


def test_console_device_rule(monkeypatch):
    monkeypatch.setenv("RUSTFHE_FORCE_CPU", "1")
    assert nander.console_device() == torch.device("cpu")
    assert nander.console_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("RUSTFHE_FORCE_CPU")
    if torch.cuda.is_available():
        assert nander.console_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="RUSTFHE_FORCE_CPU"):
        nander.nander_console(params.TEST_PARAMS, stdin=io.StringIO("1\n"), stdout=io.StringIO())


def test_python_dash_m_console():
    """``python -m rustfhe_tpu_torch.apps.nander`` delegates to the canonical
    module (one set of AST classes).  Leaf-only lines keep it free of
    bootstraps."""
    r = subprocess.run(
        [sys.executable, "-m", "rustfhe_tpu_torch.apps.nander", "--latency"],
        input="0\n1; 0; 1\n", capture_output=True, text=True, timeout=300,
        env={**os.environ, "RUSTFHE_FORCE_CPU": "1"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "res: 0" in r.stdout and "res: 1 0 1" in r.stdout, (r.stdout, r.stderr[-2000:])
    assert "engine cmux_k" in r.stdout


def test_profile_harness_and_cli_arguments(capsys):
    nander.hom_nand_profile(params.TEST_PARAMS, "cpu", iters=2, engine_name="cmux_k")
    out = capsys.readouterr().out
    assert "hom_nand:" in out and "2 nands:" in out and "us/gate" in out
    with pytest.raises(SystemExit, match="--keyfile needs a path"):
        nander.main(["--keyfile"])
