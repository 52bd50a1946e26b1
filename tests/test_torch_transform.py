"""The port's transform-domain engine ``"nuss"`` (``engine/transform.py``)
and float64-FFT engine ``"fft64"`` (``engine/fft64.py``) against the JAX
package's engines and the oracle, word for word.

``nuss`` follows ``tests/test_transform.py:32-55``: N = 64 and 256 on
random rows and digits, and the adversarial probe set at N=64; its panel
build (numpy, a second or so at N=256) stays at N <= 256 here.  JAX's
``fft64`` needs ``jax_enable_x64``: the ``x64`` fixture sets and restores
it, as ``tests/test_fft64.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import engine as jengine
from rustfhe_tpu import params as jparams
from rustfhe_tpu_torch import _u32, engine, params
from rustfhe_tpu_torch.engine import fft64, oracle, transform


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _vectors(p, batch, seed):
    rs = np.random.RandomState(seed)
    rows = rs.randint(0, 2**32, size=(2 * p.l, 2, p.N), dtype=np.uint64).astype(np.uint32)
    digits = rs.randint(-p.half_bg, p.half_bg, size=(batch, 2 * p.l, p.N)).astype(np.int32)
    return rows, digits


def _oracle(rows, digits):
    return _u32.to_numpy(oracle.external_product(_u32.from_numpy(rows), torch.from_numpy(digits)))


def test_transform_matrices_match_jax():
    from rustfhe_tpu.engine import transform as jt

    for N in (64, 256, 1024):
        assert transform.split_mr(N) == jt.split_mr(N)
        assert np.array_equal(transform.forward_matrix(N), jt.forward_matrix(N))
        assert np.array_equal(transform.inverse_matrix(N), jt.inverse_matrix(N))


@pytest.mark.parametrize("N", [64, 256])
def test_nuss_matches_jax_and_oracle(N):
    jp, p = jparams.TFHEParams(n=16, N=N), params.TFHEParams(n=16, N=N)
    rows, digits = _vectors(p, 3, 101)
    jeng, eng = jengine.get_engine("nuss"), engine.get_engine("nuss")
    jprep = np.array(jeng.prepare_trgsw(jnp.asarray(rows), jp))
    if N == 64:  # the panel builds are the same numpy code; once is enough
        assert np.array_equal(eng.prepare_trgsw(_u32.from_numpy(rows), p).numpy(), jprep)
    got = _u32.to_numpy(eng.external_product_digits(torch.from_numpy(jprep),
                                                    torch.from_numpy(digits), p))
    want = np.asarray(jeng.external_product_digits(jnp.asarray(jprep), jnp.asarray(digits), jp))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _oracle(rows, digits))


def test_nuss_on_probe_vectors():
    p = params.TFHEParams(n=16, N=64)
    assert engine.select_engine(p, "cpu", "nuss") == "nuss"
    rows, digits = engine.probe_vectors(p)
    eng = engine.get_engine("nuss")
    got = eng.external_product_digits(eng.prepare_trgsw(_u32.from_numpy(rows), p),
                                      torch.from_numpy(digits), p)
    assert np.array_equal(_u32.to_numpy(got), _oracle(rows, digits))
    a = _u32.from_numpy(rows[0])
    s = torch.from_numpy((np.arange(p.N) % 3 == 0).astype(np.int32))
    assert torch.equal(eng.poly_mul_torus_binary(a, s, p),
                       engine.get_engine("matmul").poly_mul_torus_binary(a, s, p))


@pytest.mark.parametrize("name", ["TEST_PARAMS", "DEFAULT_PARAMS"])
def test_fft64_matches_jax_and_oracle_on_probe(x64, name):
    p, jp = getattr(params, name), getattr(jparams, name)
    rows, digits = engine.probe_vectors(p)
    jeng, eng = jengine.get_engine("fft64"), engine.get_engine("fft64")
    got = _u32.to_numpy(eng.external_product_digits(eng.prepare_trgsw(_u32.from_numpy(rows), p),
                                                    torch.from_numpy(digits), p))
    want = np.asarray(jeng.external_product_digits(jeng.prepare_trgsw(jnp.asarray(rows), jp),
                                                   jnp.asarray(digits), jp))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _oracle(rows, digits))


def test_fft64_poly_mul_and_key_switch(x64):
    p, jp = params.DEFAULT_PARAMS, jparams.DEFAULT_PARAMS
    rs = np.random.RandomState(3)
    a = rs.randint(0, 2**32, size=(5, p.N), dtype=np.uint64).astype(np.uint32)
    s = rs.randint(0, 2, size=(p.N,)).astype(np.uint32)
    got = engine.get_engine("fft64").poly_mul_torus_binary(
        _u32.from_numpy(a), torch.from_numpy(s.astype(np.int32)), p)
    want = np.asarray(jengine.get_engine("fft64").poly_mul_torus_binary(jnp.asarray(a),
                                                                        jnp.asarray(s), jp))
    assert np.array_equal(_u32.to_numpy(got), want)
    # the key switch is the matmul engine's
    t = params.TEST_PARAMS
    ksk_raw = _u32.from_numpy(rs.randint(0, 2**32, size=(t.N, t.iks_l, t.iks_t, t.n + 1),
                                         dtype=np.uint64))
    d = torch.from_numpy(rs.randint(0, t.iks_t, size=(3, t.N, t.iks_l)).astype(np.int32))
    eng, m = engine.get_engine("fft64"), engine.get_engine("matmul")
    assert torch.equal(eng.key_switch_digits(eng.prepare_ksk(ksk_raw, t), d, t),
                       m.key_switch_digits(m.prepare_ksk(ksk_raw, t), d, t))
    assert engine.select_engine(t, "cpu", "fft64") == "fft64"


def test_fft64_refuses_inexact_parameters():
    fft64.check_bound(params.PBS_PARAMS)
    big = params.TFHEParams(n=16, N=1 << 15, l=2, bgbit=16)  # sums ~2^47: error ~1/2
    with pytest.raises(ValueError, match="not below 1/4"):
        fft64.check_bound(big)
    with pytest.raises(ValueError, match="not below 1/4"):
        engine.get_engine("fft64").prepare_trgsw(torch.zeros((4, 2, 8), dtype=torch.int32), big)
