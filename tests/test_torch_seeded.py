"""Seeded ciphertexts and the port's threefry against the JAX package.

``utils/threefry.py`` is held to ``jax.random`` (threefry2x32, ``split``,
``fold_in``, ``bits``) word for word, tolerance zero.  Then every case of
``tests/test_seeded.py`` but the public-key one is replayed on the port,
with keys and inputs carried from numpy seeds and JAX keys: a (seed,
bodies) pair of the JAX package expands in the port to the JAX
ciphertext word for word, the port's (seed, mask) for given key words is
JAX's, the seed is the mask subkey, and npz files cross in both
directions.  The port's noise comes from its own generator, so its bodies
are held to decryption.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from rustfhe_tpu import keys as jkeys
from rustfhe_tpu import tlwe as jtlwe
from rustfhe_tpu.params import TEST_PARAMS as J_TEST
from rustfhe_tpu.utils import serialization as jser
from rustfhe_tpu_torch import TFHE, _u32, tlwe
from rustfhe_tpu_torch.ints import FheInt, FheUint
from rustfhe_tpu_torch.params import DEFAULT_PARAMS, PBS_PARAMS, TEST_PARAMS
from rustfhe_tpu_torch.radix import RadixUint
from rustfhe_tpu_torch.utils import serialization as ser
from rustfhe_tpu_torch.utils import threefry

P = TEST_PARAMS
KEYS = {"PRNGKey(7)": np.asarray(jax.random.PRNGKey(7)),
        "edge": np.array([0xFFFFFFFF, 0x80000000], np.uint32)}
# The mask words JAX draws from the seed (1, 2) for 5 bodies (jax 0.9.0,
# jax_threefry_partitionable): row 0's first four, row 4's last four and
# the sum of all mod 2^32, at DEFAULT_PARAMS' and PBS_PARAMS' n.
# chip_smoke.py phase 15 holds the card's expansion to the same words.
PINNED_SEED = (1, 2)
PINNED_MASK = {
    635: ((0xAECE9DD7, 0x6BFF9E1C, 0x7DC7F1B1, 0x0A49EB5F),
          (0xDFD6BF01, 0x6490C046, 0x4C270E27, 0x1BBBD63B), 0xA3FA4106),
    714: ((0xAECE9DD7, 0x6BFF9E1C, 0x7DC7F1B1, 0x0A49EB5F),
          (0x45777175, 0xA3A4A928, 0x2C007A48, 0xFB28C83E), 0xDFF4689F),
}


def _np(t):
    return _u32.to_numpy(t)


def _carried_lv0(key):
    """A JAX secret key's lv0 and the same bits as the port's int32 tensor."""
    jsk = jkeys.gen_secret_key(key, J_TEST)
    return jsk, torch.from_numpy(np.asarray(jsk.lv0).astype(np.int32))


def _bits(seed, n):
    return np.random.RandomState(seed).randint(0, 2, n).astype(np.uint32)


# --------------------------------------------------------------------- #
# threefry against jax.random
# --------------------------------------------------------------------- #
def test_jax_runs_the_partitionable_threefry():
    # The port implements this form only: a change of JAX's default fails here.
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("name", list(KEYS))
@pytest.mark.parametrize("shape", [(), (1,), (5, 635), (3, 4, 7), (33, 1025)])
def test_random_bits_equals_jax(shape, name):
    key = KEYS[name]
    want = np.asarray(jax.random.bits(jnp.asarray(key), shape, jnp.uint32))
    got = threefry.random_bits(key, shape)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("num", [1, 2, 3, 7])
def test_split_equals_jax(num):
    for key in KEYS.values():
        want = np.asarray(jax.random.split(jnp.asarray(key), num))
        assert np.array_equal(_np(threefry.split(key, num)), want)


@pytest.mark.parametrize("data", [0, 1, 12345, 2**32 - 1])
def test_fold_in_equals_jax(data):
    for key in KEYS.values():
        want = np.asarray(jax.random.fold_in(jnp.asarray(key), data))
        assert np.array_equal(_np(threefry.fold_in(key, data)), want)


def test_threefry2x32_equals_jax_and_the_known_answers():
    # Random123's known answers, as JAX's own tests pin them
    for key, count, want in (((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                             ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
                             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                              (0xC4923A9C, 0x483DF7A0))):
        y0, y1 = threefry.threefry2x32(np.array(key, np.uint32),
                                       _u32.from_numpy(np.array([count[0]], np.uint32)),
                                       _u32.from_numpy(np.array([count[1]], np.uint32)))
        assert (int(_np(y0)[0]), int(_np(y1)[0])) == want
    rs = np.random.RandomState(5)
    x0, x1 = (rs.randint(0, 2**32, size=(7, 9), dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    for key in KEYS.values():
        w0, w1 = jprng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                           jnp.asarray(x0), jnp.asarray(x1))
        y0, y1 = threefry.threefry2x32(key, _u32.from_numpy(x0), _u32.from_numpy(x1))
        assert np.array_equal(_np(y0), np.asarray(w0)) and np.array_equal(_np(y1), np.asarray(w1))


def test_key_checks():
    want = _np(threefry.random_bits(KEYS["edge"], (3,)))
    for key in (torch.tensor([-1, -(2**31)], dtype=torch.int32), [0xFFFFFFFF, 0x80000000],
                np.array([-1, -(2**31)], np.int64)):
        assert np.array_equal(_np(threefry.random_bits(key, (3,))), want)
    with pytest.raises(ValueError, match=r"\(2,\)"):
        threefry.key_words(np.zeros(3, np.uint32))
    with pytest.raises(ValueError, match="32 bits"):
        threefry.key_words([0, 2**32])
    with pytest.raises(TypeError):
        threefry.key_words(torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError):
        threefry.key_words(np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="fold_in"):
        threefry.fold_in(KEYS["edge"], 2**32)
    with pytest.raises(ValueError, match="2\\^31"):
        threefry.random_bits(KEYS["edge"], (2**16, 2**15 + 1))
    with pytest.raises(ValueError, match=r"\(2,\) words"):
        tlwe.expand_seeded(np.zeros(3, np.uint32), torch.zeros(2, dtype=torch.int32), 4)


def test_pinned_mask_words_are_jax_and_the_port():
    for n, (head, tail, total) in PINNED_MASK.items():
        want = np.asarray(jtlwe.expand_seeded(np.asarray(PINNED_SEED, np.uint32),
                                              jnp.zeros((5,), jnp.uint32), n))[:, 1:]
        got = _np(tlwe.expand_seeded(np.asarray(PINNED_SEED, np.uint32),
                                     torch.zeros(5, dtype=torch.int32), n))[:, 1:]
        for a in (want, got):
            assert tuple(int(v) for v in a[0, :4]) == head
            assert tuple(int(v) for v in a[4, -4:]) == tail
            assert int(a.astype(np.uint64).sum()) & 0xFFFFFFFF == total
        assert np.array_equal(got, want)
    assert (DEFAULT_PARAMS.n, PBS_PARAMS.n) == tuple(PINNED_MASK)


# --------------------------------------------------------------------- #
# tests/test_seeded.py, replayed on the port
# --------------------------------------------------------------------- #
def test_seeded_matches_direct_bit_for_bit():
    """The port's seeded encryption under the JAX key ke gives JAX's seed
    and JAX's full ciphertext's mask, and decrypts; JAX's (seed, body)
    expands in the port to JAX's full ciphertext."""
    k = jax.random.PRNGKey(7)
    jsk, lv0 = _carried_lv0(jax.random.fold_in(k, 0))
    bits = _bits(1, 33)
    ke = jax.random.fold_in(k, 1)
    assert np.array_equal(_np(threefry.fold_in(np.asarray(k), 1)), np.asarray(ke))
    full = np.asarray(jtlwe.encrypt_binary(ke, jsk.lv0, jnp.asarray(bits), J_TEST))
    jseed, jbody = jtlwe.encrypt_binary_seeded(ke, jsk.lv0, jnp.asarray(bits), J_TEST)
    assert np.array_equal(_np(tlwe.expand_seeded(np.asarray(jseed), np.asarray(jbody), P.n)),
                          full)
    gen = torch.Generator().manual_seed(1)
    seed, body = tlwe.encrypt_binary_seeded(gen, lv0, torch.from_numpy(bits.astype(np.int32)), P,
                                            key=np.asarray(ke))
    assert np.array_equal(_np(seed), np.asarray(jseed))
    expanded = tlwe.expand_seeded(seed, body, P.n)
    assert np.array_equal(_np(expanded)[:, 1:], full[:, 1:])
    assert np.array_equal(tlwe.decrypt_binary(expanded, lv0).numpy(), bits)


def test_context_roundtrip_and_gates():
    ctx = TFHE.new(3, P, device="cpu", engine_name="matmul")
    bits = np.array([0, 1, 0, 1])
    other = np.array([0, 0, 1, 1])
    seeded = ctx.encrypt_seeded(bits)
    # Expansion is public: the cloud-only view can do it (and then compute).
    x = ctx.cloud_only().expand_seeded(seeded)
    out = ctx.decrypt(ctx.nand(x, ctx.encrypt(other))).numpy()
    assert np.array_equal(out, 1 - (bits & other))


def test_cloud_only_cannot_encrypt_seeded():
    ctx = TFHE.new(3, P, device="cpu", engine_name="matmul").cloud_only()
    with pytest.raises(ValueError, match="cloud-only"):
        ctx.encrypt_seeded([1])


def test_serialization_roundtrip_and_size(tmp_path):
    ctx = TFHE.new(9, P, device="cpu", engine_name="matmul")
    bits = _bits(2, 64)
    seeded = ctx.encrypt_seeded(bits)
    p_seed, p_full = str(tmp_path / "seeded.npz"), str(tmp_path / "full.npz")
    ser.save_seeded_ciphertexts(p_seed, seeded, P)
    ser.save_ciphertexts(p_full, ctx.expand_seeded(seeded), P)
    cts, params = ser.load_seeded_ciphertexts(p_seed, device="cpu")
    assert params == P
    assert np.array_equal(ctx.decrypt(cts).numpy(), bits)
    # body-only against (n+1) columns of uniform (incompressible) mask
    ratio = os.path.getsize(p_full) / os.path.getsize(p_seed)
    assert ratio > P.n / 4, ratio


def test_production_shape_seed_determinism():
    """The seed alone reproduces the mask at production dims, from numpy
    words or int32 tensors alike, as JAX draws it."""
    b = torch.zeros(5, dtype=torch.int32)
    ct1 = tlwe.expand_seeded(np.asarray([1, 2], np.uint32), b, DEFAULT_PARAMS.n)
    ct2 = tlwe.expand_seeded(torch.tensor([1, 2], dtype=torch.int32), b, DEFAULT_PARAMS.n)
    assert torch.equal(ct1, ct2)
    assert tuple(ct1.shape) == (5, DEFAULT_PARAMS.n + 1)
    want = jtlwe.expand_seeded(np.asarray([1, 2], np.uint32), jnp.zeros((5,), jnp.uint32),
                               DEFAULT_PARAMS.n)
    assert np.array_equal(_np(ct1), np.asarray(want))


def test_seed_is_mask_subkey_not_full_key():
    """SECURITY regression: the published seed is the mask subkey
    split(key)[0], never the key, whether the key is given or drawn from
    the context's generator."""
    k = jax.random.PRNGKey(13)
    jsk, lv0 = _carried_lv0(jax.random.fold_in(k, 0))
    ke = np.asarray(jax.random.fold_in(k, 1))
    gen = torch.Generator().manual_seed(13)
    seed, _ = tlwe.encrypt_binary_seeded(gen, lv0, torch.tensor([1, 0], dtype=torch.int32), P,
                                         key=ke)
    assert not np.array_equal(_np(seed), ke)
    assert np.array_equal(_np(seed), np.asarray(jax.random.split(jnp.asarray(ke))[0]))
    # drawn: the key is the generator's next two words
    gen = torch.Generator().manual_seed(14)
    drawn = _np(torch.randint(-(1 << 31), 1 << 31, (2,), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(14)))
    seed, _ = tlwe.encrypt_binary_seeded(gen, lv0, torch.tensor([1, 0], dtype=torch.int32), P)
    assert not np.array_equal(_np(seed), drawn)
    assert np.array_equal(_np(seed), np.asarray(jax.random.split(jnp.asarray(drawn))[0]))


def test_fheuint_seeded_roundtrip():
    """Typed-integer seeded upload: encrypt_seeded -> public expand ->
    decrypt; FheInt inherits the pair, as in the JAX package."""
    ctx = TFHE.new(17, P, device="cpu", engine_name="matmul")
    vals = np.array([3, 250, 77], np.uint64)
    a = FheUint.expand_seeded(ctx.cloud_only(), FheUint.encrypt_seeded(ctx, vals, 8))
    assert isinstance(a, FheUint)
    assert np.array_equal(FheUint(ctx, a.bits).decrypt(), vals)
    svals = np.array([-3, 127, -128], np.int64)
    s = FheInt.expand_seeded(ctx.cloud_only(), FheInt.encrypt_seeded(ctx, svals, 8))
    assert isinstance(s, FheInt)
    assert np.array_equal(FheInt(ctx, s.bits).decrypt(), svals)


def test_radix_seeded_roundtrip():
    """Radix-integer seeded upload: (seed, digit bodies) -> public expand
    -> decrypt."""
    ctx = TFHE.new(23, P, device="cpu", engine_name="matmul")
    vals = np.array([7, 255, 129], np.uint64)
    a = RadixUint.expand_seeded(ctx.cloud_only(), RadixUint.encrypt_seeded(ctx, vals, 4))
    assert np.array_equal(RadixUint(ctx, a.digits).decrypt(), vals)


# --------------------------------------------------------------------- #
# the port's own: files across the packages, the PRNG field, Queue 3
# --------------------------------------------------------------------- #
def test_npz_crosses_both_directions(tmp_path):
    k = jax.random.PRNGKey(21)
    jsk, lv0 = _carried_lv0(jax.random.fold_in(k, 0))
    bits = _bits(3, 40)
    # JAX writes, the port reads
    ke = jax.random.fold_in(k, 1)
    jseeded = jtlwe.encrypt_binary_seeded(ke, jsk.lv0, jnp.asarray(bits), J_TEST)
    jser.save_seeded_ciphertexts(str(tmp_path / "jax.npz"), jseeded, J_TEST)
    cts, params = ser.load_seeded_ciphertexts(str(tmp_path / "jax.npz"), device="cpu")
    assert params == P
    assert np.array_equal(_np(cts), np.asarray(jtlwe.encrypt_binary(ke, jsk.lv0,
                                                                    jnp.asarray(bits), J_TEST)))
    # the port writes, JAX reads (and ignores the prng field)
    gen = torch.Generator().manual_seed(21)
    seeded = tlwe.encrypt_binary_seeded(gen, lv0, torch.from_numpy(bits.astype(np.int32)), P)
    ser.save_seeded_ciphertexts(str(tmp_path / "port.npz"), seeded, P)
    with np.load(str(tmp_path / "port.npz")) as z:
        assert str(z["prng"]) == threefry.PRNG == "threefry2x32-partitionable"
    jcts, jparams = jser.load_seeded_ciphertexts(str(tmp_path / "port.npz"))
    assert jparams == J_TEST
    assert np.array_equal(np.asarray(jcts), _np(tlwe.expand_seeded(*seeded, P.n)))
    assert np.array_equal(np.asarray(jtlwe.decrypt_binary(jcts, jsk.lv0)), bits)


def test_file_naming_another_prng_raises(tmp_path):
    ctx = TFHE.new(5, P, device="cpu", engine_name="matmul")
    seed, body = ctx.encrypt_seeded([1, 0, 1])
    path = str(tmp_path / "philox.npz")
    np.savez_compressed(path, header=ser._params_header(P), seed=_np(seed), body=_np(body),
                        prng=np.array("philox4x32"))
    with pytest.raises(ValueError, match="philox4x32"):
        ser.load_seeded_ciphertexts(path, device="cpu")


def test_radix_encrypt_seeded_on_a_cloud_only_context_raises_value_error():
    """A recorded divergence (ROADMAP Queue 3): the JAX package's
    RadixUint.encrypt_seeded has no guard of its own.  On a cloud-only
    context its ``_next_key`` raises ValueError first, but a context that
    holds an encryption key and no secret key gets AttributeError from
    ``ctx.sk.lv0``.  The port raises ValueError in both cases, as
    ctx.encrypt_seeded does."""
    from rustfhe_tpu.context import TFHE as JTFHE
    from rustfhe_tpu.radix import RadixUint as JRadixUint

    vals = np.array([1], np.uint64)
    jctx = JTFHE(None, None, J_TEST, "matmul")
    with pytest.raises(ValueError, match="no encryption key"):
        JRadixUint.encrypt_seeded(jctx, vals, 4)
    jctx._enc_key = jax.random.PRNGKey(0)
    with pytest.raises(AttributeError, match="lv0"):
        JRadixUint.encrypt_seeded(jctx, vals, 4)
    ctx = TFHE.new(3, P, device="cpu", engine_name="matmul")
    keyless = TFHE(None, ctx.ck, P, "cpu", ctx.gen, ctx.engine_name)
    for c in (ctx.cloud_only(), keyless):
        with pytest.raises(ValueError, match="cloud-only"):
            RadixUint.encrypt_seeded(c, vals, 4)
