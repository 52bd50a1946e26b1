"""The port's gate bootstrap, as a whole, against the JAX package.

Shared keys: the JAX package's raw keys cross into the port through
``keys.from_jax_keys``, so both packages bootstrap the same pre-combined
ciphertexts under the same keys and must agree word for word (tolerance
zero).  The port's own keygen and encryption draw from a torch generator,
whose bits differ from jax's threefry: those paths are held to correct
decryption of every gate's truth table.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import bootstrap as jbootstrap
from rustfhe_tpu import gates as jgates
from rustfhe_tpu import keys as jkeys
from rustfhe_tpu import params as jparams
from rustfhe_tpu import tlwe as jtlwe
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu_torch import TFHE, _u32, bootstrap, gates, keys, params, tlwe
from rustfhe_tpu_torch.engine import cmux_k


@functools.lru_cache(maxsize=None)
def _jax_keys(name, seed=3):
    jp = getattr(jparams, name)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    sk = jkeys.gen_secret_key(k1, jp)
    bk_raw, ksk_raw = jkeys.gen_cloud_key_raw(k2, sk, jp, "matmul")
    return tuple(np.asarray(x) for x in (sk.lv0, sk.lv1, bk_raw, ksk_raw))


def _jax_precombined(name, batch, seed=4):
    """A mixed pre-combined batch (NAND, AND, OR, XOR, NOT lanes over the
    four input pairs), encrypted by the JAX package; returns (pre, want
    bits) as numpy."""
    jp = getattr(jparams, name)
    lv0 = jnp.asarray(_jax_keys(name)[0])
    ops = ["nand", "and", "or", "xor", "not"]
    truth = {"nand": lambda x, y: 1 - (x & y), "and": lambda x, y: x & y,
             "or": lambda x, y: x | y, "xor": lambda x, y: x ^ y, "not": lambda x, y: 1 - x}
    bx = np.tile([0, 1, 0, 1], batch)[:batch].astype(np.uint32)
    by = np.tile([0, 0, 1, 1], batch)[:batch].astype(np.uint32)
    kx, ky = jax.random.split(jax.random.PRNGKey(seed))
    cx = jtlwe.encrypt_binary(kx, lv0, jnp.asarray(bx), jp)
    cy = jtlwe.encrypt_binary(ky, lv0, jnp.asarray(by), jp)
    pres, wants = [], []
    for i in range(batch):
        op = ops[i % len(ops)]
        pres.append(np.asarray(jgates.precombine(op, cx[i], cy[i], params=jp)))
        wants.append(truth[op](int(bx[i]), int(by[i])))
    return np.stack(pres), np.array(wants)


def test_from_jax_keys_round_trip():
    p, jp = params.TEST_PARAMS, jparams.TEST_PARAMS
    lv0, lv1, bk_raw, ksk_raw = _jax_keys("TEST_PARAMS")
    sk, ck = keys.from_jax_keys(lv0, lv1, bk_raw, ksk_raw, p, "cpu")
    assert np.array_equal(_u32.to_numpy(sk.lv0), lv0)
    assert np.array_equal(_u32.to_numpy(sk.lv1), lv1)
    neg = (~bk_raw + np.uint32(1)).astype(np.uint32)
    assert np.array_equal(_u32.to_numpy(ck.bk), np.concatenate([neg, bk_raw], axis=-1))
    assert ck.ksk.shape == (p.iks_t - 1, p.N * p.iks_l, p.n + 1)
    # ciphertexts cross both ways under the shared key
    bits = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.uint32)
    jct = np.asarray(jtlwe.encrypt_binary(jax.random.PRNGKey(9), jnp.asarray(lv0),
                                          jnp.asarray(bits), jp))
    assert np.array_equal(tlwe.decrypt_binary(_u32.from_numpy(jct), sk.lv0).numpy(), bits)
    gen = torch.Generator().manual_seed(9)
    pct = tlwe.encrypt_binary(gen, sk.lv0, torch.from_numpy(bits.astype(np.int32)), p)
    assert np.array_equal(
        np.asarray(jtlwe.decrypt_binary(jnp.asarray(_u32.to_numpy(pct)), jnp.asarray(lv0))), bits)
    with pytest.raises(ValueError, match="bk_raw"):
        keys.from_jax_keys(lv0, lv1, bk_raw[:-1], ksk_raw, p, "cpu")


def _parity(name, batch):
    p, jp = getattr(params, name), getattr(jparams, name)
    lv0, lv1, bk_raw, ksk_raw = _jax_keys(name)
    pre, want_bits = _jax_precombined(name, batch)
    m = get_engine("matmul")
    jck = jkeys.CloudKey(bk=m.prepare_trgsw(jnp.asarray(bk_raw), jp),
                         ksk=m.prepare_ksk(jnp.asarray(ksk_raw), jp))
    want_lv1 = np.asarray(jbootstrap.gate_bootstrapping_tlwe2tlwe(jnp.asarray(pre), jck.bk, jp, m))
    want = np.asarray(jgates.hom_bootstrap(jck, jnp.asarray(pre), params=jp, engine_name="matmul"))

    sk, ck = keys.from_jax_keys(lv0, lv1, bk_raw, ksk_raw, p, "cpu")
    t_pre = _u32.from_numpy(pre)
    got_lv1 = bootstrap.gate_bootstrapping_tlwe2tlwe(t_pre, ck.bk, p)
    assert np.array_equal(_u32.to_numpy(got_lv1), want_lv1)
    got = gates.hom_bootstrap(ck, t_pre, params=p)
    assert np.array_equal(_u32.to_numpy(got), want)
    assert np.array_equal(tlwe.decrypt_binary(got, sk.lv0).numpy(), want_bits)


def test_bootstrap_matches_jax_word_for_word():
    _parity("TEST_PARAMS", 20)


@pytest.mark.slow
def test_bootstrap_matches_jax_word_for_word_default_params():
    _parity("DEFAULT_PARAMS", 5)


def test_context_defaults_to_the_card(monkeypatch):
    # TFHE.new runs on the CUDA card unless the caller names the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TFHE.new(0, params.TEST_PARAMS)
    assert TFHE.new(0, params.TEST_PARAMS, device="cpu").device == torch.device("cpu")


def test_port_keygen_gates_truth_tables():
    ctx = TFHE.new(11, params.TEST_PARAMS, device="cpu")
    assert ctx.engine_name == "cmux_k"
    x = ctx.encrypt([0, 1, 0, 1])
    y = ctx.encrypt([0, 0, 1, 1])
    before = cmux_k.cmux_step.launches
    assert ctx.decrypt(ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert ctx.decrypt(ctx.and_(x, y)).tolist() == [0, 0, 0, 1]
    assert ctx.decrypt(ctx.or_(x, y)).tolist() == [0, 1, 1, 1]
    assert ctx.decrypt(ctx.xor(x, y)).tolist() == [0, 1, 1, 0]
    assert ctx.decrypt(ctx.not_(x)).tolist() == [1, 0, 1, 0]
    assert cmux_k.cmux_step.launches == before  # CPU: the plain version only
    combos = np.array([[c, a, b] for c in (0, 1) for a in (0, 1) for b in (0, 1)])
    c, i0, i1 = (ctx.encrypt(combos[:, k]) for k in range(3))
    want = np.where(combos[:, 0] == 1, combos[:, 2], combos[:, 1])
    assert ctx.decrypt(ctx.mux(c, i0, i1)).numpy().tolist() == want.tolist()
    # trivial constants bootstrap too, and the cloud-only view cannot decrypt
    t = ctx.trivial([1, 0])
    assert ctx.decrypt(ctx.nand(t, t)).tolist() == [0, 1]
    cloud = ctx.cloud_only()
    with pytest.raises(ValueError):
        cloud.decrypt(t)
    with pytest.raises(ValueError):
        cloud.encrypt([1])


def test_port_keys_decrypt_in_jax():
    # Port-made keys bootstrap, and JAX decrypts the result under lv0.
    p = params.TEST_PARAMS
    gen = torch.Generator().manual_seed(12)
    sk, ck = keys.gen_keys(gen, p, "cpu")
    bits = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    ct = tlwe.encrypt_binary(gen, sk.lv0, bits, p)
    out = gates.hom_bootstrap(ck, gates.precombine("not", ct, params=p), params=p)
    got = jtlwe.decrypt_binary(jnp.asarray(_u32.to_numpy(out)), jnp.asarray(_u32.to_numpy(sk.lv0)))
    assert np.asarray(got).tolist() == [1, 0, 0, 1]
