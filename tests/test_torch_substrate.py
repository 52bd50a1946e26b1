"""Port substrate against the JAX package: the u32 helpers, the parameter
presets, the torus codec, both decompositions, rotation and limb splits.

Inputs are made with numpy from fixed seeds and go through both packages
on the CPU; every comparison is exact (tolerance zero, words mod 2^32).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import decomp as jdecomp
from rustfhe_tpu import params as jparams
from rustfhe_tpu import poly as jpoly
from rustfhe_tpu import torus as jtorus
from rustfhe_tpu_torch import _u32, decomp, params, poly, torus

EDGE_WORDS = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)


def _words(seed, shape):
    rs = np.random.RandomState(seed)
    w = rs.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[: len(EDGE_WORDS)] = EDGE_WORDS[: flat.size]
    return w


def _t(a):
    return _u32.from_numpy(a)


def _np(t):
    return _u32.to_numpy(t)


# --------------------------------------------------------------------- #
# _u32 helpers on the edge words
# --------------------------------------------------------------------- #
def test_u32_round_trip_and_wrapping_ops():
    a = np.repeat(EDGE_WORDS, len(EDGE_WORDS))
    b = np.tile(EDGE_WORDS, len(EDGE_WORDS))
    ta, tb = _t(a), _t(b)
    assert np.array_equal(_np(ta), a)
    with np.errstate(over="ignore"):
        assert np.array_equal(_np(ta + tb), a + b)
        assert np.array_equal(_np(ta - tb), a - b)
        assert np.array_equal(_np(ta * tb), a * b)
    assert np.array_equal(_np(-ta), (~a + np.uint32(1)).astype(np.uint32))
    assert np.array_equal(_np(ta ^ tb), a ^ b)
    for k in range(32):
        assert np.array_equal(_np(ta << k), (a << np.uint32(k)).astype(np.uint32)), k


@pytest.mark.parametrize("k", [0, 1, 5, 14, 21, 31])
def test_u32_logical_shift(k):
    a = _words(0, (64,))
    assert np.array_equal(_np(_u32.srl(_t(a), k)), a >> np.uint32(k))


def test_u32_unsigned_compare():
    a = np.repeat(EDGE_WORDS, len(EDGE_WORDS))
    b = np.tile(EDGE_WORDS, len(EDGE_WORDS))
    assert np.array_equal(_u32.ult(_t(a), _t(b)).numpy(), a < b)
    for w in EDGE_WORDS:
        assert np.array_equal(_u32.ult(_t(a), int(w)).numpy(), a < w)


def test_u32_wrap_and_s32():
    vals = np.array([0, 1, -1, 2**31, 2**32 + 7, -(2**40) - 3, 2**52], np.int64)
    got = _np(_u32.wrap(torch.from_numpy(vals)))
    assert np.array_equal(got, (vals % (1 << 32)).astype(np.uint32))
    got_f = _np(_u32.wrap(torch.from_numpy(vals.astype(np.float64))))
    assert np.array_equal(got_f, got)
    for w in EDGE_WORDS:
        assert np.int32(_u32.s32(int(w))).view(np.uint32) == w


def test_u32_numpy_views_both_ways():
    a = _words(1, (3, 4))
    t = _t(a)
    assert t.dtype == torch.int32 and t.shape == (3, 4)
    assert np.array_equal(t.numpy(), a.view(np.int32))
    assert _np(t).dtype == np.uint32
    with pytest.raises(TypeError):
        _u32.to_numpy(t.to(torch.int64))


# --------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------- #
PRESET_NAMES = ["DEFAULT_PARAMS", "TEST_PARAMS", "N2048_PARAMS", "PBS_PARAMS",
                "PBS_TEST_PARAMS", "FAST_PARAMS"]


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_presets_equal_jax(name):
    mine, ref = getattr(params, name), getattr(jparams, name)
    for f in dataclasses.fields(ref):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    for prop in ("nbit", "bg", "half_bg", "decomp_mask", "iks_t", "iks_round", "mu", "two_n"):
        assert getattr(mine, prop) == getattr(ref, prop), prop


def test_production_decomp_mask():
    assert params.DEFAULT_PARAMS.decomp_mask == 0x2084000
    for l in range(1, 6):
        for bits in range(1, 33 // l):
            assert params._make_decomp_mask(l, bits) == jparams._make_decomp_mask(l, bits)
            assert decomp.make_decomp_mask_inline(l, bits) == \
                jdecomp.make_decomp_mask_inline(l, bits)


def test_params_validation():
    with pytest.raises(ValueError):
        params.TFHEParams(N=1000)
    with pytest.raises(ValueError):
        params.TFHEParams(l=6, bgbit=6)


# --------------------------------------------------------------------- #
# Torus codec
# --------------------------------------------------------------------- #
def test_from_double_matches_jax():
    xs = np.array([0.0, 0.5, 0.25, 0.125, -0.5, -0.25, 0.4, 0.123, 3.1, -3.1, 1e-10,
                   -1e-10, -1e-30, 0.9999999, -0.9999999, 1e6 + 0.75, -2.0**-15, 2.0**-25,
                   7.0, -7.0], np.float32)
    rs = np.random.RandomState(2)
    xs = np.concatenate([xs, (rs.randn(4096) * 2.0**-15).astype(np.float32),
                         rs.uniform(-8, 8, 1024).astype(np.float32)])
    want = np.asarray(jtorus.from_double(jnp.asarray(xs)))
    got = _np(torus.from_double(torch.from_numpy(xs)))
    assert np.array_equal(got, want)
    # integer input goes through float32, as in the JAX package
    ints = np.array([0, 1, -3], np.int32)
    assert np.array_equal(_np(torus.from_double(torch.from_numpy(ints))),
                          np.asarray(jtorus.from_double(jnp.asarray(ints))))


def test_torus_codec_golden_and_parity():
    # math.rs:994-998 bit patterns
    enc = lambda f: int(_np(torus.from_double(torch.tensor([f], dtype=torch.float32)))[0])
    assert enc(0.5) == 1 << 31
    assert enc(0.25) == 1 << 30
    assert enc(0.125) == 1 << 29
    assert enc(-0.5) == 1 << 31
    assert enc(-0.25) == (1 << 30) + (1 << 31)
    bits = np.array([0, 1, 1, 0, 5], np.int32)
    assert np.array_equal(_np(torus.binary_to_torus(torch.from_numpy(bits))),
                          np.asarray(jtorus.binary_to_torus(jnp.asarray(bits))))
    w = _words(3, (512,))
    assert np.array_equal(torus.torus_to_binary(_t(w)).numpy().astype(np.uint32),
                          np.asarray(jtorus.torus_to_binary(jnp.asarray(w))))


# --------------------------------------------------------------------- #
# Decomposition
# --------------------------------------------------------------------- #
def _sdec(x, bits, l):
    mask = decomp.make_decomp_mask_inline(l, bits)
    return decomp.decompose_signed_custom(_t(np.array(x, np.uint32)), bits, l, mask).tolist()


def _udec(x, bits, l):
    return decomp.decompose_unsigned_custom(_t(np.array(x, np.uint32)), bits, l).tolist()


def test_decomposition_golden_vectors():
    # the golden vectors of tests/test_decomp.py (math.rs:1206-1273, 866-893)
    res = _udec(0x80000000, 1, 32)
    assert res[0] == 1 and all(v == 0 for v in res[1:])
    res = _sdec(0x80000000, 1, 32)
    assert res[0] == -1 and all(v == 0 for v in res[1:])
    assert _sdec(0x80000000, 4, 8) == [-8, 0, 0, 0, 0, 0, 0, 0]
    assert _sdec(0x80000000, 4, 7) == [-8, 0, 0, 0, 0, 0, 0]
    res = _udec(0x80000001, 1, 31)
    assert res[0] == 1 and all(v == 0 for v in res[1:30]) and res[30] == 1
    res = _sdec(0x80000001, 1, 31)
    assert res[0] == 0 and all(v == -1 for v in res[1:])
    assert _sdec(0b00000100001000001100000000000000, 6, 3) == [1, 2, 3]
    assert _sdec(0b00000100001000001110000000000000, 6, 3) == [1, 2, 4]
    assert _sdec(0b01111110000010000000000010000000, 6, 3) == [-32, -31, -32]
    mask = decomp.make_decomp_mask_inline(2, 16)
    d = decomp.decompose_signed_custom(_t(np.array([1, 0x28000], np.uint32)), 16, 2, mask)
    assert d.tolist() == [[0, 1], [3, -32768]]


@pytest.mark.parametrize("name", ["DEFAULT_PARAMS", "PBS_PARAMS", "FAST_PARAMS"])
def test_decompositions_match_jax(name):
    p, jp = getattr(params, name), getattr(jparams, name)
    w = _words(4, (4096,))
    got = decomp.decompose_signed(_t(w), p).numpy()
    want = np.asarray(jdecomp.decompose_signed(jnp.asarray(w), jp))
    assert np.array_equal(got, want)
    assert got.min() >= -p.half_bg and got.max() < p.half_bg
    got_u = decomp.decompose_unsigned(_t(w), p).numpy()
    want_u = np.asarray(jdecomp.decompose_unsigned(jnp.asarray(w), jp))
    assert np.array_equal(got_u.astype(np.uint32), want_u)
    # every (bits, l) split of 32 bits, both masks, the edge words included
    for bits, l in [(1, 32), (2, 16), (4, 8), (8, 4), (16, 2), (6, 5), (7, 3)]:
        for m in (jdecomp.make_decomp_mask(l, bits), jdecomp.make_decomp_mask_inline(l, bits)):
            a = decomp.decompose_signed_custom(_t(w[:256]), bits, l, m).numpy()
            b = np.asarray(jdecomp.decompose_signed_custom(jnp.asarray(w[:256]), bits, l, m))
            assert np.array_equal(a, b), (bits, l)
        a = decomp.decompose_unsigned_custom(_t(w[:256]), bits, l).numpy().astype(np.uint32)
        b = np.asarray(jdecomp.decompose_unsigned_custom(jnp.asarray(w[:256]), bits, l))
        assert np.array_equal(a, b), (bits, l)


def test_decompose_all_ones_word():
    # 0xFFFFFFFF: the word where an arithmetic shift would leak sign bits.
    p = params.DEFAULT_PARAMS
    x = np.array([0xFFFFFFFF], np.uint32)
    assert np.array_equal(decomp.decompose_signed(_t(x), p).numpy(),
                          np.asarray(jdecomp.decompose_signed(jnp.asarray(x), jparams.DEFAULT_PARAMS)))
    assert np.array_equal(decomp.decompose_unsigned(_t(x), p).numpy().astype(np.uint32),
                          np.asarray(jdecomp.decompose_unsigned(jnp.asarray(x),
                                                                jparams.DEFAULT_PARAMS)))


# --------------------------------------------------------------------- #
# Rotation and limbs
# --------------------------------------------------------------------- #
def test_rotate_golden():
    # tests/test_poly.py::test_rotate_golden (math.rs:75-84, 894-903)
    p = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32)
    cases = {1: [-5, 1, 2, 3, 4], 3: [-3, -4, -5, 1, 2], -1: [2, 3, 4, 5, -1],
             -3: [4, 5, -1, -2, -3], 5: [-1, -2, -3, -4, -5], -4: [5, -1, -2, -3, -4],
             10: [1, 2, 3, 4, 5]}
    for n, expect in cases.items():
        assert poly.rotate(p, n).tolist() == expect, n
    assert poly.rotate(p, -8).tolist() == poly.rotate(p, 2).tolist()
    # X^N * p == -p, wrapping
    assert _np(poly.rotate(torch.tensor([1, 0, 0, 0], dtype=torch.int32), 4))[0] == 0xFFFFFFFF


def test_rotate_and_rotate_binary_match_jax():
    w = _words(7, (6, 2, 32))
    rs = np.random.RandomState(8)
    ns = rs.randint(0, 64, size=(6, 1)).astype(np.int32)
    want = np.asarray(jpoly.rotate(jnp.asarray(w), jnp.asarray(ns)))
    assert np.array_equal(_np(poly.rotate(_t(w), torch.from_numpy(ns))), want)
    assert np.array_equal(_np(poly.rotate_binary(_t(w), torch.from_numpy(ns))), want)
    # one rotation per batch item against a shared (2, N) polynomial
    tv = _words(9, (2, 64))
    nb = rs.randint(0, 128, size=(5,)).astype(np.int32)
    want = np.asarray(jpoly.rotate_binary(jnp.asarray(tv), jnp.asarray(nb)[:, None]))
    assert np.array_equal(_np(poly.rotate(_t(tv), torch.from_numpy(nb)[:, None])), want)
    for n in (0, 1, 31, 32, 33, 63, -5, 1000):
        assert np.array_equal(_np(poly.rotate(_t(w), n)),
                              np.asarray(jpoly.rotate(jnp.asarray(w), n))), n


def test_to_signed_limbs_matches_jax():
    w = _words(10, (1000,))
    for bits in (8, 4, 16):
        got = poly.to_signed_limbs(_t(w), bits, 32 // bits, dtype=torch.int32).numpy()
        want = np.asarray(jpoly.to_signed_limbs(jnp.asarray(w), bits, 32 // bits,
                                                dtype=jnp.int32))
        assert np.array_equal(got, want), bits
        assert np.abs(got).max() <= 1 << (bits - 1)
    assert poly.to_signed_limbs(_t(w), 8, 4).dtype == torch.int8


def test_oracle_product_matches_jax():
    rs = np.random.RandomState(1)
    a = _words(11, (3, 32))
    b = rs.randint(-32, 32, size=(3, 32)).astype(np.int32)
    want = np.asarray(jpoly.negacyclic_mul_torus_oracle(jnp.asarray(a), jnp.asarray(b)))
    got = poly.negacyclic_mul_torus_oracle(_t(a), torch.from_numpy(b), chunk=8)
    assert np.array_equal(_np(got), want)
    # hand values: (1 + 2X)(3 + 4X) = -5 + 10X mod X^2 + 1
    got = poly.negacyclic_mul_torus_oracle(torch.tensor([1, 2], dtype=torch.int32),
                                           torch.tensor([3, 4]))
    assert got.tolist() == [-5, 10]
