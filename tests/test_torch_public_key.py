"""Public-key encryption in the port: every case of tests/test_public_key.py
and tests/test_seeded.py::test_public_key_rows_floor, on the port at
TEST_PARAMS, a test's own CPU ``torch.Generator`` in place of JAX's
``key=``.  The port's public form is dual-Regev (noise on every
coordinate, JAX's on the body only): randomised encryptions are held to
decryption, and keys and ciphertexts cross between the packages.  Then the
mask noise itself, and the decryption and gates at DEFAULT_PARAMS.
"""

import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import keys as jkeys
from rustfhe_tpu import params as jparams
from rustfhe_tpu import tlwe as jtlwe
from rustfhe_tpu_torch import FheUint, TFHE, _u32, keys, params, tlwe
from rustfhe_tpu_torch.params import DEFAULT_PARAMS, TEST_PARAMS


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def ctx():
    return TFHE.new(21, TEST_PARAMS, device="cpu", engine_name="matmul")


def test_public_encrypt_decrypts(ctx):
    pk = ctx.make_public_key()
    assert pk.shape == (2 * (TEST_PARAMS.n + 1), TEST_PARAMS.n + 1)
    assert pk.dtype == torch.int32
    bits = np.random.RandomState(0).randint(0, 2, 64)
    # A KEYLESS party encrypts: cloud-only context + explicit generator.
    cloud = ctx.cloud_only()
    cts = cloud.encrypt_public(pk, bits, gen=_gen(99))
    assert np.array_equal(ctx.decrypt(cts).numpy(), bits)


def test_public_encryptions_are_randomized(ctx):
    pk = ctx.make_public_key()
    one = torch.tensor([1], dtype=torch.int32)
    c1 = tlwe.encrypt_binary_public(_gen(0), pk, one, TEST_PARAMS)
    c2 = tlwe.encrypt_binary_public(_gen(1), pk, one, TEST_PARAMS)
    assert not torch.equal(c1, c2)
    for c in (c1, c2):
        assert ctx.decrypt(c).tolist() == [1]


def test_gates_on_public_ciphertexts(ctx):
    pk = ctx.make_public_key()
    x = ctx.encrypt_public(pk, [0, 1, 0, 1])
    y = ctx.encrypt_public(pk, [0, 0, 1, 1])
    assert ctx.decrypt(ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert ctx.decrypt(ctx.xor(x, y)).tolist() == [0, 1, 1, 0]


def test_cloud_only_cannot_make_public_key(ctx):
    with pytest.raises(ValueError, match="cloud-only"):
        ctx.cloud_only().make_public_key()


def test_fheuint_public_encryption(ctx):
    """Keyless typed-integer encryption: a cloud-only party encrypts
    integers under the public key; the key holder decrypts them."""
    pk = ctx.make_public_key()
    vals = np.array([9, 200, 0], np.uint64)
    a = FheUint.encrypt_public(ctx.cloud_only(), pk, vals, 8, gen=_gen(31))
    assert np.array_equal(FheUint(ctx, a.bits).decrypt(), vals)


def test_client_server_example_runs(monkeypatch, capsys):
    """The port of the three-party example runs as ``python3 -m`` runs it
    (``runpy``, in this process) on the CPU, asserts internally, and
    prints its closing line."""
    monkeypatch.setenv("RUSTFHE_FORCE_CPU", "1")
    monkeypatch.delenv("RUSTFHE_ENGINE", raising=False)
    runpy.run_module("rustfhe_tpu_torch.examples.client_server", run_name="__main__")
    assert "both decode correctly" in capsys.readouterr().out


def test_public_key_rows_floor():
    """Too-few pk rows (an enumerable subset sum) must raise; n+1 rows is
    the floor."""
    sk = keys.gen_secret_key(_gen(1), TEST_PARAMS, "cpu")
    with pytest.raises(ValueError, match="rows"):
        tlwe.gen_public_key(_gen(2), sk.lv0, TEST_PARAMS, rows=TEST_PARAMS.n)
    pk = tlwe.gen_public_key(_gen(2), sk.lv0, TEST_PARAMS, rows=TEST_PARAMS.n + 1)
    assert pk.shape == (TEST_PARAMS.n + 1, TEST_PARAMS.n + 1)


# ------------------------------ the port's own ------------------------------ #
def test_public_key_rows_encrypt_zero_and_batches_keep_their_shape(ctx):
    """pk rows are encryptions of zero (phase within 8 sigma of 0); a
    message batch of any shape gets a ciphertext of that shape, with an
    independent subset per message."""
    pk = ctx.make_public_key(rows=40)
    assert pk.shape == (40, TEST_PARAMS.n + 1)
    phase = tlwe.phase(pk, ctx.sk.lv0).to(torch.float64) / 2.0**32
    assert float(phase.abs().max()) <= 8 * TEST_PARAMS.alpha_lv0
    bits = np.random.RandomState(4).randint(0, 2, (3, 5))
    cts = ctx.encrypt_public(pk, np.ones((3, 5), np.int32))
    assert cts.shape == (3, 5, TEST_PARAMS.n + 1)
    assert len({tuple(c.tolist()) for c in cts.reshape(15, -1)}) == 15
    cts = ctx.encrypt_public(pk, bits)
    assert np.array_equal(ctx.decrypt(cts).numpy(), bits)


def test_encrypt_public_needs_a_generator_on_the_context_device(ctx):
    pk = ctx.make_public_key()
    with pytest.raises(ValueError, match="gen="):
        ctx.cloud_only().encrypt_public(pk, [1, 0])
    with pytest.raises(ValueError, match="cloud-only"):
        FheUint.encrypt_public(ctx.cloud_only(), pk, [3], 4)


@pytest.mark.parametrize("name", ["TEST_PARAMS", "DEFAULT_PARAMS"])
def test_public_mask_carries_noise(name):
    """With a public key whose mask columns are zero, the mask words of a
    public ciphertext are exactly its fresh mask noise: not all zero, each
    within 8 sigma of zero (sigma = alpha_lv0).  The JAX form leaves those
    words zero (ROADMAP Queue 3: the dual-Regev divergence)."""
    p, jp = getattr(params, name), getattr(jparams, name)
    rows = 2 * (p.n + 1)
    pk = _u32.from_numpy(np.random.RandomState(6).randint(0, 2**32, (rows, p.n + 1),
                                                          dtype=np.uint64))
    pk[:, 1:] = 0
    m = torch.zeros(64, dtype=torch.int32)
    ct = tlwe.encrypt_torus_public(_gen(7), pk, m, p)
    noise = ct[:, 1:].to(torch.float64) / 2.0**32  # signed torus values
    assert bool((noise != 0).any())
    assert float(noise.abs().max()) <= 8 * p.alpha_lv0
    assert 0.5 * p.alpha_lv0 < float(noise.std()) < 2 * p.alpha_lv0
    jct = np.asarray(jtlwe.encrypt_torus_public(jax.random.PRNGKey(7),
                                                jnp.asarray(_u32.to_numpy(pk)),
                                                jnp.zeros(64, jnp.uint32), jp))
    assert not jct[:, 1:].any()  # JAX's mask: a noiseless subset sum


def test_public_keys_and_ciphertexts_cross_with_jax():
    """On one secret key (JAX's words, carried into the port): the port
    encrypts under a JAX public key and JAX decrypts; JAX encrypts under a
    port public key and the port decrypts."""
    p, jp = TEST_PARAMS, jparams.TEST_PARAMS
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(8), 3)
    jsk = jkeys.gen_secret_key(k1, jp)
    lv0, lv1 = np.asarray(jsk.lv0), np.asarray(jsk.lv1)
    jpk = np.asarray(jtlwe.gen_public_key(k2, jsk.lv0, jp))
    ctx = TFHE(keys.SecretKey(_u32.from_numpy(lv0), _u32.from_numpy(lv1)), None, p, "cpu",
               _gen(9))
    bits = np.random.RandomState(10).randint(0, 2, 32)
    got = ctx.encrypt_public(jpk, bits)
    assert np.array_equal(np.asarray(jtlwe.decrypt_binary(jnp.asarray(_u32.to_numpy(got)),
                                                          jsk.lv0)), bits)
    pk = ctx.make_public_key()
    jct = jtlwe.encrypt_binary_public(k3, jnp.asarray(_u32.to_numpy(pk)),
                                      jnp.asarray(bits, jnp.uint32), jp)
    assert np.array_equal(ctx.decrypt(_u32.from_numpy(np.asarray(jct))).numpy(), bits)


@pytest.fixture(scope="module")
def default_ctx():
    return TFHE.new(3, DEFAULT_PARAMS, device="cpu")


def test_public_encrypt_decrypts_at_default(default_ctx):
    pk = default_ctx.make_public_key()
    assert pk.shape == (1272, 636)
    bits = np.random.RandomState(11).randint(0, 2, 256)
    cts = default_ctx.cloud_only().encrypt_public(pk, bits, gen=_gen(12))
    assert np.array_equal(default_ctx.decrypt(cts).numpy(), bits)


@pytest.mark.slow
def test_gates_on_public_ciphertexts_at_default(default_ctx):
    """NAND and XOR through the K1 engine's plain version at DEFAULT_PARAMS
    on public ciphertexts (~40 s on the CPU)."""
    pk = default_ctx.make_public_key()
    x = default_ctx.encrypt_public(pk, [0, 1, 0, 1])
    y = default_ctx.encrypt_public(pk, [0, 0, 1, 1])
    assert default_ctx.engine_name == "cmux_k"
    assert default_ctx.decrypt(default_ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert default_ctx.decrypt(default_ctx.xor(x, y)).tolist() == [0, 1, 1, 0]
