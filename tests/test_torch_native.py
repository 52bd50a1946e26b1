"""The port's host library (``rustfhe_tpu_torch/native.py`` on
``csrc/negacyclic_host.cpp``) against the JAX package's
(``rustfhe_tpu/native.py`` on ``native/negacyclic.cpp``) and against its own
numpy fallbacks: every case of tests/test_native.py on the port, the u32
and torus products equal to JAX's word for word (the same source and
flags give the same bits), the f64 product within 1e-9 of JAX's relative
to max|a| * max|b| * N.
"""

import numpy as np
import pytest

from rustfhe_tpu import native as jnative
from rustfhe_tpu_torch import native, poly
from rustfhe_tpu_torch.apps.circuits import ripple_carry_adder

SIZES = [2, 4, 16, 64, 256, 1024, 2048]


def _operands(N, seed, bound=32):
    rs = np.random.RandomState(seed)
    a = rs.randint(0, 2**32, size=(N,), dtype=np.uint64).astype(np.uint32)
    b = rs.randint(-bound, bound, size=(N,)).astype(np.int32)
    return a, b


def test_native_available():
    assert native.available(), "the port's host library failed to build or load"
    assert native.build().parent == native.BUILD_DIR


def test_exact_u32_conv_matches_oracle():
    a, b = _operands(256, 0)
    got = native.negacyclic_mul_u32_exact(a, b)
    want = (poly.negacyclic_mul_i64(a.astype(np.int64), b) % (1 << 32)).astype(np.uint32)
    assert np.array_equal(got, want)


def test_fft_f64_small_hand_case():
    # (1 + 2X)(3 + 4X) mod X^2+1 = -5 + 10X
    out = native.negacyclic_mul_f64_fft(np.array([1.0, 2.0]), np.array([3.0, 4.0]))
    assert np.allclose(out, [-5.0, 10.0], atol=1e-9)


def test_fft_torus_vs_exact_tolerance():
    # the reference's fft-vs-exact check at N=1024, torus tolerance 1e-6
    rs = np.random.RandomState(1)
    N = 1024
    for _ in range(3):
        a = rs.randint(0, 2**32, size=(N,), dtype=np.uint64).astype(np.uint32)
        b = rs.randint(0, 2, size=(N,)).astype(np.int32)
        diff = (native.negacyclic_mul_torus_fft(a, b)
                - native.negacyclic_mul_u32_exact(a, b)).astype(np.uint32)
        wrap = np.minimum(diff.astype(np.int64), (1 << 32) - diff.astype(np.int64))
        assert (wrap.astype(np.float64) / 2**32).max() < 1e-6


def test_levelizer_matches_python():
    c = ripple_carry_adder(8)
    inputs3 = np.full((len(c.gates), 3), -1, np.int64)
    outputs = np.zeros(len(c.gates), np.int64)
    for g_idx, g in enumerate(c.gates):
        for t, w in enumerate(g.inputs):
            inputs3[g_idx, t] = w
        outputs[g_idx] = g.output
    levels, depth = native.levelize(len(c.gates), c.n_wires, c.n_inputs, inputs3, outputs)
    assert depth == c.depth
    py_level = {g.output: lv for lv, layer in enumerate(c.levelize(), start=1) for g in layer}
    for g_idx, g in enumerate(c.gates):
        assert levels[g_idx] == py_level[g.output]


@pytest.mark.parametrize("N", SIZES)
def test_u32_and_torus_products_equal_jax_word_for_word(N):
    assert jnative.available()
    a, b = _operands(N, N)
    assert np.array_equal(native.negacyclic_mul_u32_exact(a, b),
                          jnative.negacyclic_mul_u32_exact(a, b))
    assert np.array_equal(native.negacyclic_mul_torus_fft(a, b),
                          jnative.negacyclic_mul_torus_fft(a, b))


@pytest.mark.parametrize("N", SIZES)
def test_f64_product_matches_jax(N):
    rs = np.random.RandomState(N + 1)
    a, b = rs.standard_normal(N) * 1e3, rs.standard_normal(N)
    got, want = native.negacyclic_mul_f64_fft(a, b), jnative.negacyclic_mul_f64_fft(a, b)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(a).max() * np.abs(b).max() * N


@pytest.mark.parametrize("N", [2, 64, 1024])
def test_numpy_fallbacks_against_the_library(N):
    a, b = _operands(N, N + 2)
    assert np.array_equal(native.negacyclic_mul_u32_exact_numpy(a, b),
                          native.negacyclic_mul_u32_exact(a, b))
    assert np.array_equal(native.negacyclic_mul_torus_fft_numpy(a, b),
                          native.negacyclic_mul_torus_fft(a, b))
    fa, fb = a.astype(np.int32).astype(np.float64), b.astype(np.float64)
    err = np.abs(native.negacyclic_mul_f64_fft_numpy(fa, fb)
                 - native.negacyclic_mul_f64_fft(fa, fb)).max()
    assert err <= 1e-9 * np.abs(fa).max() * np.abs(fb).max() * N


def test_products_refuse_mismatched_operands():
    a, b = _operands(16, 3)
    with pytest.raises(ValueError, match="one length"):
        native.negacyclic_mul_u32_exact(a, b[:8])
    with pytest.raises(ValueError, match="one length"):
        native.negacyclic_mul_torus_fft(a.reshape(4, 4), b.reshape(4, 4))
    with pytest.raises(ValueError, match="n=3"):
        native.negacyclic_mul_f64_fft(np.ones(3), np.ones(3))
