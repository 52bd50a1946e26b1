"""The port's public API beside the JAX package's: the gate functions
``gates.hom_*`` and ``GATES_2IN``, the engine registry and selector
(``register_engine``, ``get_engine``, ``select_fast_engine``,
``RUSTFHE_ENGINE``), the ``"oracle"`` engine, the renamed functions'
aliases, the package root's names and ``utils/timing``.

The gates are held to JAX's ``gates.hom_*`` on ``"matmul"`` word for word
(tolerance zero) at TEST_PARAMS: both packages bootstrap the same
JAX-encrypted ciphertexts on the same raw keys, made by the port's keygen
and carried into JAX as numpy words (``keys.from_jax_keys`` takes them back
into the port).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustfhe_tpu
from rustfhe_tpu import decomp as jdecomp
from rustfhe_tpu import engine as jengine
from rustfhe_tpu import gates as jgates
from rustfhe_tpu import keys as jkeys
from rustfhe_tpu import params as jparams
from rustfhe_tpu import tlwe as jtlwe
import rustfhe_tpu_torch
from rustfhe_tpu_torch import TFHE, _u32, decomp, engine, gates, keys, tlwe
from rustfhe_tpu_torch.engine import cmux_k
from rustfhe_tpu_torch.params import DEFAULT_PARAMS, TEST_PARAMS
from rustfhe_tpu_torch.utils import timing

P, JP = TEST_PARAMS, jparams.TEST_PARAMS
GATES = ["nand", "and", "or", "xor", "not", "mux"]
C, X, Y = (np.array(b, np.uint32) for b in ([0, 0, 0, 0, 1, 1, 1, 1], [0, 1, 0, 1, 0, 1, 0, 1],
                                           [0, 0, 1, 1, 0, 0, 1, 1]))
TRUTH = {"nand": 1 - (X & Y), "and": X & Y, "or": X | Y, "xor": X ^ Y, "not": 1 - X,
         "mux": np.where(C == 1, Y, X)}


@functools.lru_cache(maxsize=None)
def _raw_keys():
    gen = torch.Generator().manual_seed(5)
    sk = keys.gen_secret_key(gen, P, "cpu")
    return tuple(_u32.to_numpy(a) for a in (sk.lv0, sk.lv1, *keys.gen_cloud_key_raw(gen, sk, P)))


@functools.lru_cache(maxsize=None)
def _jax_inputs():
    """JAX's ciphertexts of C, X, Y under the raw keys' lv0, and JAX's
    cloud key on "matmul"."""
    lv0, _, bk_raw, ksk_raw = _raw_keys()
    m = jengine.get_engine("matmul")
    ck = jkeys.CloudKey(bk=jax.jit(functools.partial(m.prepare_trgsw, params=JP))(
                            jnp.asarray(bk_raw)),
                        ksk=jax.jit(functools.partial(m.prepare_ksk, params=JP))(
                            jnp.asarray(ksk_raw)))
    cts = jax.jit(functools.partial(jtlwe.encrypt_binary, params=JP))(
        jax.random.PRNGKey(6), jnp.asarray(lv0), jnp.asarray(np.stack([C, X, Y])))
    return ck, cts


def _args(gate, cts):
    c, x, y = cts[0], cts[1], cts[2]
    return {"not": (x,), "mux": (c, x, y)}.get(gate, (x, y))


@functools.lru_cache(maxsize=None)
def _jax_gate(gate):
    ck, cts = _jax_inputs()
    fn = jgates.GATES_2IN.get(gate) or getattr(jgates, f"hom_{gate}")
    return np.asarray(fn(ck, *_args(gate, cts), params=JP, engine_name="matmul"))


@pytest.mark.parametrize("eng", ["matmul", "cmux_k"])
@pytest.mark.parametrize("gate", GATES)
def test_hom_gates_match_jax_word_for_word(gate, eng):
    want = _jax_gate(gate)
    sk, ck = keys.from_jax_keys(*_raw_keys(), P, "cpu", eng)
    cts = _u32.from_numpy(np.asarray(_jax_inputs()[1]))
    fn = gates.GATES_2IN.get(gate) or getattr(gates, f"hom_{gate}")
    got = fn(ck, *_args(gate, cts), params=P, engine_name=eng)
    assert np.array_equal(_u32.to_numpy(got), want)
    assert np.array_equal(tlwe.decrypt_binary(got, sk.lv0).numpy(), TRUTH[gate])
    # the key's form decides the engine: no name runs the same words
    assert torch.equal(fn(ck, *_args(gate, cts), params=P), got)


def test_gates_2in_and_the_context_agree():
    assert list(gates.GATES_2IN) == list(jgates.GATES_2IN)
    assert gates.GATES_2IN["nand"] is gates.hom_nand
    assert [f.__name__ for f in gates.GATES_2IN.values()] == [
        f"hom_{k}" for k in gates.GATES_2IN]
    ctx = TFHE.new(3, P, device="cpu")
    x, y, c = ctx.encrypt(X), ctx.encrypt(Y), ctx.encrypt(C)
    methods = {"nand": ctx.nand, "and": ctx.and_, "or": ctx.or_, "xor": ctx.xor}
    for name, fn in gates.GATES_2IN.items():
        assert torch.equal(fn(ctx.ck, x, y, params=P), methods[name](x, y))
    assert torch.equal(gates.hom_not(ctx.ck, x, params=P), ctx.not_(x))
    assert torch.equal(gates.hom_mux(ctx.ck, c, x, y, params=P), ctx.mux(c, x, y))


def test_a_named_engine_that_does_not_match_the_key_raises():
    _, ck = keys.from_jax_keys(*_raw_keys(), P, "cpu", "cmux_k")
    cts = _u32.from_numpy(np.asarray(_jax_inputs()[1]))
    with pytest.raises(ValueError, match="prepared for 'cmux_k'"):
        gates.hom_nand(ck, cts[1], cts[2], params=P, engine_name="matmul")
    with pytest.raises(ValueError, match="prepared for 'cmux_k'"):
        gates.hom_mux(ck, cts[0], cts[1], cts[2], params=P, engine_name="fft64")
    # a caller names engines by the port's names; only RUSTFHE_ENGINE's are mapped
    with pytest.raises(KeyError, match="unknown engine"):
        gates.hom_not(ck, cts[1], params=P, engine_name="pallas_k2")


class _CountingOracle(engine.OracleEngine):
    """A user engine: the oracle's product, counted."""

    name = "counting_oracle"
    calls = 0

    def external_product_digits(self, prepared, digits, params):
        type(self).calls += 1
        return super().external_product_digits(prepared, digits, params)


def test_register_engine_is_honoured_by_get_engine_and_the_context(monkeypatch):
    monkeypatch.setattr(engine, "_ENGINES", dict(engine._ENGINES))
    eng = _CountingOracle()
    assert isinstance(eng, engine.PolyEngine)
    engine.register_engine("counting_oracle", eng)
    assert engine.get_engine("counting_oracle") is eng
    assert engine.resolve_engine("counting_oracle") is eng
    assert rustfhe_tpu_torch.get_engine("counting_oracle") is eng
    ctx = TFHE.new(4, P, device="cpu", engine_name="counting_oracle")
    assert ctx.engine_name == "counting_oracle"
    assert keys.key_engine(ctx.ck.bk) == "counting_oracle"
    before = _CountingOracle.calls
    out = gates.hom_nand(ctx.ck, ctx.encrypt(X), ctx.encrypt(Y), params=P,
                         engine_name="counting_oracle")
    assert ctx.decrypt(out).tolist() == TRUTH["nand"].tolist()
    assert _CountingOracle.calls - before == P.n  # one product per blind-rotation step
    with pytest.raises(TypeError, match="not an engine"):
        engine.probe_ops(object(), P)


def test_engines_are_poly_engines():
    for name in ("matmul", "matmul_bf16", "fft64", "nuss", "oracle"):
        assert isinstance(engine.get_engine(name), engine.PolyEngine), name
    for name in ("cmux_k", "limb"):
        assert not isinstance(engine.get_engine(name), engine.PolyEngine), name


def test_oracle_engine_matches_jax():
    rows, digits = engine.probe_vectors(P)
    jo, o = jengine.get_engine("oracle"), engine.get_engine("oracle")
    want = np.asarray(jo.external_product_digits(jo.prepare_trgsw(jnp.asarray(rows), JP),
                                                 jnp.asarray(digits), JP))
    got = o.external_product_digits(o.prepare_trgsw(_u32.from_numpy(rows), P),
                                    torch.from_numpy(digits), P)
    assert np.array_equal(_u32.to_numpy(got), want)
    rs = np.random.RandomState(7)
    a = rs.randint(0, 2**32, (3, P.N), dtype=np.uint64).astype(np.uint32)
    s = rs.randint(0, 2, P.N).astype(np.uint32)
    assert np.array_equal(
        _u32.to_numpy(o.poly_mul_torus_binary(_u32.from_numpy(a), torch.from_numpy(s), P)),
        np.asarray(jo.poly_mul_torus_binary(jnp.asarray(a), jnp.asarray(s), JP)))
    ksk = rs.randint(0, 2**32, (P.N, P.iks_l, P.iks_t, P.n + 1), dtype=np.uint64).astype(np.uint32)
    d = rs.randint(0, P.iks_t + 1, (5, P.N, P.iks_l)).astype(np.int32)
    want = np.asarray(jo.key_switch_digits(jo.prepare_ksk(jnp.asarray(ksk), JP),
                                           jnp.asarray(d), JP))
    got = o.key_switch_digits(o.prepare_ksk(_u32.from_numpy(ksk), P), torch.from_numpy(d), P)
    assert np.array_equal(_u32.to_numpy(got), want)
    assert engine._probe_engine("oracle", P, "cpu") == (True, "exact")


def test_select_fast_engine_is_select_engines_choice():
    assert engine.select_fast_engine(P, "cpu") == engine.select_engine(P, "cpu") == "matmul"
    assert engine.select_fast_engine(device="cpu") == "cmux_k"  # DEFAULT_PARAMS
    assert engine.engine_for(DEFAULT_PARAMS) == "cmux_k"


@pytest.mark.parametrize("env, want", [("pallas_k2", "cmux_k"), ("pallas_k", "cmux_k"),
                                       ("pallas", "limb"), ("matmul", "matmul"),
                                       ("fft64", "fft64"), ("oracle", "oracle")])
def test_rustfhe_engine_names_the_engine(monkeypatch, env, want):
    monkeypatch.setenv("RUSTFHE_ENGINE", env)
    assert engine.JAX_ENGINE_NAMES.get(env, env) == want
    assert engine.requested_engine(P).name == want
    assert engine.select_engine(P, "cpu") == want
    assert engine.select_fast_engine(P, "cpu") == want
    # a caller's name wins over the variable, as a JAX caller's name skips the probe cascade
    assert engine.select_engine(P, "cpu", "matmul") == "matmul"


def test_rustfhe_engine_passes_names_through_as_jax_does(monkeypatch):
    monkeypatch.setenv("RUSTFHE_ENGINE", "matmul")
    assert jengine.select_fast_engine(JP) == engine.select_fast_engine(P, "cpu") == "matmul"
    assert TFHE.new(0, P, device="cpu").engine_name == "matmul"
    monkeypatch.setenv("RUSTFHE_ENGINE", "pallas_k")
    ctx = TFHE.new(0, P, device="cpu")
    assert ctx.engine_name == "cmux_k"
    # the sharded builders default to the same engine: the key is checked
    # before any collective runs, so no process group is needed here
    from rustfhe_tpu_torch.parallel import sharded

    monkeypatch.setenv("RUSTFHE_ENGINE", "matmul")
    with pytest.raises(ValueError, match="prepared for 'cmux_k', the sharded function for "
                                         "'matmul'"):
        sharded.sharded_gate_fn(None, P)(ctx.ck.bk, ctx.ck.ksk, *ctx.encrypt([[0], [1]]))


def _broken(digits, key, params_, _k2=cmux_k.external_product):
    out = _k2(digits, key, params_)
    out[0, 0, 0] += 1
    return out


def test_a_named_engine_that_fails_its_probe_raises(monkeypatch):
    monkeypatch.setattr(cmux_k, "external_product", _broken)
    monkeypatch.setenv("RUSTFHE_ENGINE", "pallas_k2")
    with pytest.raises(RuntimeError, match="cmux_k engine's external product on cpu failed"):
        engine.select_fast_engine(P, "cpu")
    with pytest.raises(RuntimeError, match="failed the oracle probe"):
        TFHE.new(0, P, device="cpu")
    assert not engine._probe_engine("cmux_k", P, "cpu")[0]
    monkeypatch.setenv("RUSTFHE_ENGINE", "no_such_engine")
    with pytest.raises(KeyError, match="unknown engine"):
        engine.select_engine(P, "cpu")


def test_aliases():
    gen_a, gen_b = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    sk = keys.gen_secret_key(gen_a, P, "cpu")
    keys.gen_secret_key(gen_b, P, "cpu")
    ck = keys.gen_cloud_key(gen_a, sk, P, engine="matmul")
    ck_ref = keys.prepare_cloud_key(*keys.gen_cloud_key_raw(gen_b, sk, P), P, "matmul")
    assert torch.equal(ck.bk.table, ck_ref.bk.table) and torch.equal(ck.ksk, ck_ref.ksk)
    assert keys.cloud_key_panels is keys.cloud_key_latency
    lat = keys.cloud_key_panels(keys.gen_cloud_key(gen_a, sk, P))
    assert isinstance(lat.bk, keys.LatencyBK)
    for l, bits in [(3, 6), (2, 8), (4, 6), (3, 10), (4, 8), (8, 2)]:
        assert decomp.make_decomp_mask(l, bits) == jdecomp.make_decomp_mask(l, bits)
    from rustfhe_tpu_torch.parallel import sharded

    assert sharded.key_engine is keys.key_engine


def test_package_root_exposes_every_name_of_the_jax_package():
    for name in rustfhe_tpu.__all__:
        assert hasattr(rustfhe_tpu_torch, name), name
    assert set(rustfhe_tpu.__all__) <= set(rustfhe_tpu_torch.__all__)
    assert rustfhe_tpu_torch.N2048_PARAMS.N == 2048
    assert rustfhe_tpu_torch.gates is gates and rustfhe_tpu_torch.decomp is decomp


def test_timing_helpers(capsys, tmp_path):
    held = {}
    x = torch.arange(8)
    with timing.timeit("block", held, sync=x):
        x.sum()
    assert "block" in held and capsys.readouterr().out.startswith("block: ")
    calls = []
    best, out = timing.time_fn(lambda a: calls.append(a) or a * 2, x, iters=3, warmup=2,
                               device="cpu")
    assert len(calls) == 5 and torch.equal(out, x * 2) and 0 <= best < 1
    with timing.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(4) + 1
    assert prof.key_averages() is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
