"""Port engine against the JAX package: the oracle, the plain external
product, the key switch and the torus x binary product, word for word on
the CPU (tolerance zero), plus the engine selector's probe.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import bootstrap as jbootstrap
from rustfhe_tpu import engine as jengine
from rustfhe_tpu import params as jparams
from rustfhe_tpu_torch import _u32, bootstrap, engine, params
from rustfhe_tpu_torch.engine import cmux_k, oracle, plain

NAMES = ["TEST_PARAMS", "DEFAULT_PARAMS"]


def _pair(name):
    return getattr(params, name), getattr(jparams, name)


def _words(seed, shape):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def test_probe_vectors_same_bits_as_jax():
    for name in NAMES + ["PBS_PARAMS"]:
        p, jp = _pair(name)
        rows, digits = engine.probe_vectors(p)
        jrows, jdigits = jengine.probe_vectors(jp)
        assert rows.dtype == np.uint32 and digits.dtype == np.int32
        assert np.array_equal(rows, jrows) and np.array_equal(digits, jdigits)


@pytest.mark.parametrize("name", NAMES)
def test_oracle_and_plain_external_product_match_jax_on_probe(name):
    p, jp = _pair(name)
    rows, digits = engine.probe_vectors(p)
    joracle = jengine.get_engine("oracle")
    jmatmul = jengine.get_engine("matmul")
    want = np.asarray(joracle.external_product_digits(
        joracle.prepare_trgsw(jnp.asarray(rows), jp), jnp.asarray(digits), jp))
    want_m = np.asarray(jmatmul.external_product_digits(
        jmatmul.prepare_trgsw(jnp.asarray(rows), jp), jnp.asarray(digits), jp))
    assert np.array_equal(want, want_m)

    t_rows, t_digits = _u32.from_numpy(rows), torch.from_numpy(digits)
    got_oracle = oracle.external_product(t_rows, t_digits)
    assert np.array_equal(_u32.to_numpy(got_oracle), want)
    got_plain = plain.external_product(t_digits.to(torch.int8), plain.prepare_trgsw(t_rows))
    assert np.array_equal(_u32.to_numpy(got_plain), want)


def test_plain_external_product_random_and_int8_extremes():
    p, jp = _pair("TEST_PARAMS")
    rs = np.random.RandomState(5)
    rows = _words(6, (2 * p.l, 2, p.N))
    # the full int8 range: the float64 bound covers |d| <= 128
    digits = rs.randint(-128, 128, size=(9, 2 * p.l, p.N)).astype(np.int32)
    digits[0] = -128
    jm = jengine.get_engine("matmul")
    want = np.asarray(jm.external_product_digits(
        jm.prepare_trgsw(jnp.asarray(rows), jp), jnp.asarray(digits), jp))
    got = plain.external_product(torch.from_numpy(digits).to(torch.int8),
                                 plain.prepare_trgsw(_u32.from_numpy(rows)))
    assert np.array_equal(_u32.to_numpy(got), want)
    with pytest.raises(TypeError):
        plain.external_product(torch.from_numpy(digits),
                               plain.prepare_trgsw(_u32.from_numpy(rows)))


def test_prepare_trgsw_is_the_doubled_table():
    rows = _words(7, (6, 2, 16))
    t = plain.prepare_trgsw(_u32.from_numpy(rows))
    neg = (~rows + np.uint32(1)).astype(np.uint32)
    assert np.array_equal(_u32.to_numpy(t), np.concatenate([neg, rows], axis=-1))


@pytest.mark.parametrize("N", [64, 1024])
def test_poly_mul_torus_binary_matches_jax(N):
    jp = jparams.TFHEParams(n=16, N=N)
    rs = np.random.RandomState(3)
    a = _words(8, (5, N))
    a[0, :4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    s = rs.randint(0, 2, size=(N,)).astype(np.uint32)
    jm = jengine.get_engine("matmul")
    want = np.asarray(jm.poly_mul_torus_binary(jnp.asarray(a), jnp.asarray(s), jp))
    got = plain.poly_mul_torus_binary(_u32.from_numpy(a), torch.from_numpy(s.astype(np.int32)))
    assert np.array_equal(_u32.to_numpy(got), want)


@pytest.mark.parametrize("name", NAMES)
def test_key_switch_matches_jax(name):
    # Random raw KSK words and lv1 ciphertexts at the preset's dimensions
    # (1024 -> 635 at DEFAULT): the key switch is exact integer arithmetic,
    # so any words compare, the edge words included.
    p, jp = _pair(name)
    ksk_raw = _words(9, (p.N, p.iks_l, p.iks_t, p.n + 1))
    ct1 = _words(10, (6, p.N + 1))
    ct1[0, :5] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    jm = jengine.get_engine("matmul")
    want = np.asarray(jbootstrap.identity_key_switch(
        jnp.asarray(ct1), jm.prepare_ksk(jnp.asarray(ksk_raw), jp), jp, jm))
    got = bootstrap.identity_key_switch(
        _u32.from_numpy(ct1), plain.prepare_ksk(_u32.from_numpy(ksk_raw), p), p)
    assert np.array_equal(_u32.to_numpy(got), want)


def test_select_engine_admits_plain_on_cpu():
    # On the CPU the engine's wrappers run its kernels' plain versions.
    assert engine.select_engine(params.TEST_PARAMS, "cpu") == "cmux_k"


_K2 = cmux_k.external_product


def _broken(digits, key, params_):
    out = _K2(digits, key, params_)
    out[0, 0, 0] += 1
    return out


def test_probe_result_reports_inexact(monkeypatch):
    p = params.TEST_PARAMS
    rows, digits = engine.probe_vectors(p)
    t_rows, t_digits = _u32.from_numpy(rows), torch.from_numpy(digits)
    want = oracle.external_product(t_rows, t_digits)
    ok, why = engine.engine_probe_result(cmux_k.external_product, p, t_rows, t_digits, want)
    assert ok and why == "exact"
    ok, why = engine.engine_probe_result(_broken, p, t_rows, t_digits, want)
    assert not ok and "1/" in why
    monkeypatch.setattr(cmux_k, "external_product", _broken)
    with pytest.raises(RuntimeError, match="failed the oracle probe"):
        engine.select_engine(p, "cpu")
