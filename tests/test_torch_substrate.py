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


# --------------------------------------------------------------------- #
# The rest of the substrate: tlwe, torus, decomp, poly, trlwe, trgsw
# --------------------------------------------------------------------- #
def test_tlwe_constants_and_linear_ops_match_jax():
    from rustfhe_tpu import tlwe as jtlwe
    from rustfhe_tpu_torch import tlwe

    for n in (1, 16, 635):
        assert np.array_equal(_np(tlwe.logic_true(n, "cpu")), np.asarray(jtlwe.logic_true(n)))
        assert np.array_equal(_np(tlwe.logic_false(n, "cpu")), np.asarray(jtlwe.logic_false(n)))
    ct = _words(20, (5, 3, 17))
    assert np.array_equal(_np(tlwe.body(_t(ct))), np.asarray(jtlwe.body(jnp.asarray(ct))))
    assert np.array_equal(_np(tlwe.mask(_t(ct))), np.asarray(jtlwe.mask(jnp.asarray(ct))))
    for k in (0, 1, -1, 3, -7, 2**31 + 5, 2**32 + 2, -(2**40) - 3):
        assert np.array_equal(_np(tlwe.mul_int(_t(ct), k)),
                              np.asarray(jtlwe.mul_int(jnp.asarray(ct), k))), k


def test_torus_helpers_match_jax():
    w = _words(21, (4096,))
    # JAX without x64 decodes in float32; the port in float64, which
    # rounds to the same float32.
    got = torus.to_double(_t(w))
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), w.astype(np.float64) / 2.0**32)
    assert np.array_equal(got.numpy().astype(np.float32), np.asarray(jtorus.to_double(jnp.asarray(w))))
    v = np.array([0, 1, 2, 3, 7, 31, 255], np.int32)
    for shift in range(0, 40):
        want = np.asarray(jtorus.signed_to_torus(jnp.asarray(v), shift))
        assert np.array_equal(_np(torus.signed_to_torus(torch.from_numpy(v), shift)), want), shift
    assert _np(torus.signed_to_torus(3, 8)).tolist() == 3 << 24
    for k in range(0, 40):
        assert torus.pow_two_minus(k) & 0xFFFFFFFF == int(jtorus.pow_two_minus(k)), k
    a = _words(22, (2048,))
    rs = np.random.RandomState(23)
    near = (a.astype(np.int64) + rs.randint(-2**23, 2**23, size=a.shape)) % 2**32
    b = np.concatenate([_words(24, (1024,)), near[1024:].astype(np.uint32)])
    b[:4] = a[:4] + np.array([0, 1, 0x7FFFFFFF, 0x80000000], np.uint32)
    for r in (0, 1, 8, 10, 20, 31, 32):
        want = np.asarray(jtorus.is_in(jnp.asarray(a), jnp.asarray(b), r))
        assert np.array_equal(torus.is_in(_t(a), _t(b), r).numpy(), want), r


def test_iks_round_constant_and_recompose_match_jax():
    for bits, l in ((2, 8), (4, 4), (3, 5), (8, 4), (16, 2)):
        assert decomp.iks_round_constant(bits, l) == jdecomp.iks_round_constant(bits, l)
    rs = np.random.RandomState(25)
    for name in ("TEST_PARAMS", "DEFAULT_PARAMS", "FAST_PARAMS", "PBS_PARAMS"):
        p, jp = getattr(params, name), getattr(jparams, name)
        d = rs.randint(-(1 << (p.bgbit - 1)), 1 << (p.bgbit - 1), size=(64, p.l)).astype(np.int32)
        want = np.asarray(jdecomp.recompose_signed(jnp.asarray(d), jp))
        assert np.array_equal(_np(decomp.recompose_signed(torch.from_numpy(d), p)), want)
        # decompose then recompose: the word up to the gadget's rounding (the
        # production mask rounds within two units of the last digit)
        w = _words(26, (256,))
        back = decomp.recompose_signed(decomp.decompose_signed(_t(w), p), p)
        err = (_np(back).astype(np.int64) - w.astype(np.int64) + 2**31) % 2**32 - 2**31
        assert np.abs(err).max() < 2 << (32 - p.bgbit * p.l)


def test_negacyclic_mul_i64_and_from_signed_limbs_match_jax():
    rs = np.random.RandomState(27)
    a = rs.randint(-2**20, 2**20, size=(3, 64)).astype(np.int64)
    b = rs.randint(-64, 64, size=(3, 64)).astype(np.int64)
    assert np.array_equal(poly.negacyclic_mul_i64(a, b), jpoly.negacyclic_mul_i64(a, b))
    assert poly.negacyclic_mul_i64([1, 2], [3, 4]).tolist() == [-5, 10]
    w = _words(28, (1000,))
    for bits in (8, 4, 16):
        limbs = poly.to_signed_limbs(_t(w), bits, 32 // bits, dtype=torch.int32)
        assert np.array_equal(_np(poly.from_signed_limbs(limbs, bits)), w)
        want = np.asarray(jpoly.from_signed_limbs(jnp.asarray(limbs.numpy()), bits))
        assert np.array_equal(_np(poly.from_signed_limbs(limbs, bits)), want)
    odd = np.random.RandomState(29).randint(-128, 128, size=(50, 5)).astype(np.int8)
    assert np.array_equal(_np(poly.from_signed_limbs(torch.from_numpy(odd), 8)),
                          np.asarray(jpoly.from_signed_limbs(jnp.asarray(odd), 8)))


def _jax_poly_keys(p, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2, size=p.N).astype(np.uint32)


def test_trlwe_binary_poly_round_trip_and_jax_decrypt():
    import jax

    from rustfhe_tpu import trlwe as jtrlwe
    from rustfhe_tpu.engine import get_engine
    from rustfhe_tpu_torch import trlwe

    p, jp = params.TEST_PARAMS, jparams.TEST_PARAMS
    s = _jax_poly_keys(p, 30)
    bits = np.random.RandomState(31).randint(0, 2, size=(4, p.N))
    gen = torch.Generator().manual_seed(32)
    ct = trlwe.encrypt_binary_poly(gen, _t(s), torch.from_numpy(bits), p)
    assert ct.shape == (4, 2, p.N) and ct.dtype == torch.int32
    assert np.array_equal(trlwe.decrypt_binary_poly(ct, _t(s)).numpy(), bits)
    # JAX's encryption, decrypted by both packages: the same bits.
    eng = get_engine("matmul")
    jct = jtrlwe.encrypt_binary_poly(jax.random.PRNGKey(33), jnp.asarray(s), jnp.asarray(bits),
                                     jp, eng)
    got = trlwe.decrypt_binary_poly(_t(np.asarray(jct)), _t(s)).numpy()
    assert np.array_equal(got, np.asarray(jtrlwe.decrypt_binary_poly(jct, jnp.asarray(s), jp, eng)))
    assert np.array_equal(got, bits)


TRGSW_ITEMS = {  # encryption -> (its decryption, the item's kind)
    "encrypt_int_poly": ("decrypt_int_poly", "ints"),
    "encrypt_uint_poly": ("decrypt_uint_poly", "ints"),
    "encrypt_binary_poly": ("decrypt_binary_poly", "bits"),
    "encrypt_int": ("decrypt_int", "scalars"),
    "encrypt_binary": ("decrypt_binary", "bit"),
}


@pytest.mark.parametrize("enc_name", list(TRGSW_ITEMS))
@pytest.mark.parametrize("name", ["TEST_PARAMS", "DEFAULT_PARAMS"])
def test_trgsw_item_encryptions_round_trip_and_match_jax_decrypt(name, enc_name):
    """The port's encryption decrypts to the item (randomised: held to
    decryption); JAX's encryption decrypts in the port to JAX's words."""
    import jax

    from rustfhe_tpu import trgsw as jtrgsw
    from rustfhe_tpu.engine import get_engine
    from rustfhe_tpu_torch import trgsw

    p, jp = getattr(params, name), getattr(jparams, name)
    s, js = _t(_jax_poly_keys(p, 34)), jnp.asarray(_jax_poly_keys(p, 34))
    dec_name, kind = TRGSW_ITEMS[enc_name]
    rs = np.random.RandomState(35)
    half = p.bg // 2
    item = {"ints": lambda: rs.randint(-half + 1, half + 1, size=(2, p.N)),
            "bits": lambda: rs.randint(0, 2, size=(2, p.N)),
            "scalars": lambda: rs.randint(-half + 1, half + 1, size=(3,)),
            "bit": lambda: rs.randint(0, 2, size=(3,))}[kind]().astype(np.int32)
    rep = getattr(trgsw, enc_name)(torch.Generator().manual_seed(36), s, torch.from_numpy(item), p)
    lead = item.shape[:-1] if "poly" in enc_name else item.shape
    assert rep.shape == lead + (2 * p.l, 2, p.N) and rep.dtype == torch.int32
    got = getattr(trgsw, dec_name)(rep, s, p)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), item)
    jrep = getattr(jtrgsw, enc_name)(jax.random.PRNGKey(37), js, jnp.asarray(item), jp,
                                     get_engine("matmul"))
    want = np.asarray(getattr(jtrgsw, dec_name)(jrep, js, jp, get_engine("matmul")))
    got = _np(getattr(trgsw, dec_name)(_t(np.asarray(jrep)), s, p))
    assert np.array_equal(got, want.astype(np.uint32))
    assert np.array_equal(got.view(np.int32), item)


@pytest.mark.parametrize("name", ["TEST_PARAMS", "DEFAULT_PARAMS", "PBS_PARAMS"])
def test_round_phase_to_digit_matches_jax(name):
    from rustfhe_tpu import trgsw as jtrgsw
    from rustfhe_tpu_torch import trgsw

    p, jp = getattr(params, name), getattr(jparams, name)
    w = _words(38, (4096,))
    assert np.array_equal(trgsw._round_phase_to_digit(_t(w), p).numpy(),
                          np.asarray(jtrgsw._round_phase_to_digit(jnp.asarray(w), jp)))


def test_port_imports_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (their tests import both)."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "rustfhe_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "rustfhe_tpu"), f"{path}: imports {name}"
