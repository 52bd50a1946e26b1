"""Parameter-sweep parity: the port at the shapes of tests/test_params_sweep.py
and tests/test_production_dims.py, word for word against the JAX package.

Both packages compute on the same raw keys, as numpy uint32 words that
``keys.from_jax_keys`` carries into the port: they are made by the port's
keygen (seed 13 or 41) because JAX's eager raw keygen costs ~8 s a shape on
the CPU.  On those keys both packages bootstrap the same JAX-encrypted
ciphertexts: the NAND at the four sweep shapes (N=128; l=2 with bgbit=8;
iks_basebit=4 with iks_l=4; FAST's gadget at n=64, N=256), on the port's
``"matmul"`` engine and on K1's plain version, and the identity key switch
at both reference dimension pairs (1024 -> 635, 256 -> 60), each equal to
JAX's output with tolerance zero and decrypting right.  DEFAULT_PARAMS'
constants are the reference's.
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
from rustfhe_tpu.engine import get_engine as jget_engine
from rustfhe_tpu_torch import _u32, bootstrap, gates, keys, tlwe
from rustfhe_tpu_torch.engine import plain
from rustfhe_tpu_torch.params import DEFAULT_PARAMS, TFHEParams

SWEEP = {
    # N=128 (nbit 7), tiny n for CPU speed
    "N128": dict(n=8, N=128, alpha_lv0=2.0**-20, alpha_lv1=2.0**-28),
    # different gadget levels: l=2, bgbit=8
    "l2_bg8": dict(n=12, N=64, alpha_lv0=2.0**-20, alpha_lv1=2.0**-28, bgbit=8, l=2),
    # key-switch variations: basebit 4, 4 levels
    "iks4x4": dict(n=12, N=64, alpha_lv0=2.0**-20, alpha_lv1=2.0**-28, iks_basebit=4, iks_l=4),
    # the FAST preset's gadget shape at production noise levels
    "fast_gadget": dict(n=64, N=256, bgbit=8, l=2),
}
XS, YS = np.array([0, 1, 0, 1], np.uint32), np.array([0, 0, 1, 1], np.uint32)


def _jit(fn, jp):
    """``fn(..., params=jp)`` under one jit: the eager JAX ops compile one
    by one, several times slower on the CPU."""
    return jax.jit(functools.partial(fn, params=jp))


def _raw_keys(p: TFHEParams, seed: int):
    """(lv0, lv1, bk_raw, ksk_raw) as numpy uint32 words, from the port's
    keygen."""
    gen = torch.Generator().manual_seed(seed)
    sk = keys.gen_secret_key(gen, p, "cpu")
    return tuple(_u32.to_numpy(a) for a in (sk.lv0, sk.lv1, *keys.gen_cloud_key_raw(gen, sk, p)))


@functools.lru_cache(maxsize=None)
def _jax_nand(shape):
    """The raw keys, JAX's ciphertexts of XS, YS under them and JAX's NAND
    on "matmul", all as numpy."""
    jp = jparams.TFHEParams(**SWEEP[shape])
    lv0, lv1, bk_raw, ksk_raw = _raw_keys(TFHEParams(**SWEEP[shape]), 13)
    m = jget_engine("matmul")
    ck = jkeys.CloudKey(bk=_jit(m.prepare_trgsw, jp)(jnp.asarray(bk_raw)),
                        ksk=_jit(m.prepare_ksk, jp)(jnp.asarray(ksk_raw)))
    cx, cy = _jit(jtlwe.encrypt_binary, jp)(jax.random.PRNGKey(13), jnp.asarray(lv0),
                                            jnp.asarray(np.stack([XS, YS])))
    out = jgates.hom_nand(ck, cx, cy, params=jp, engine_name="matmul")
    return lv0, lv1, bk_raw, ksk_raw, np.asarray(cx), np.asarray(cy), np.asarray(out)


@pytest.mark.parametrize("engine", ["matmul", "cmux_k"])
@pytest.mark.parametrize("shape", list(SWEEP))
def test_nand_across_params_matches_jax(shape, engine):
    p = TFHEParams(**SWEEP[shape])
    lv0, lv1, bk_raw, ksk_raw, cx, cy, want = _jax_nand(shape)
    sk, ck = keys.from_jax_keys(lv0, lv1, bk_raw, ksk_raw, p, "cpu", engine)
    got = gates.hom_nand(ck, _u32.from_numpy(cx), _u32.from_numpy(cy), params=p,
                         engine_name=engine)
    assert np.array_equal(_u32.to_numpy(got), want), (shape, engine)
    assert tlwe.decrypt_binary(got, sk.lv0).tolist() == [1, 1, 1, 0]


@pytest.mark.parametrize(
    "p",
    [DEFAULT_PARAMS,  # 1024 -> 635, the production pair (tlwe.rs:347-371)
     TFHEParams(n=60, N=256, alpha_lv0=2.0**-15, alpha_lv1=2.0**-25)],  # tlwe.rs:373-396
    ids=["prod_1024_to_635", "ref_256_to_60"],
)
def test_identity_key_switch_production_dims_matches_jax(p):
    jp = jparams.TFHEParams(**{f.name: getattr(p, f.name)
                               for f in p.__dataclass_fields__.values()})
    gen = torch.Generator().manual_seed(41)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ksk_raw = _u32.to_numpy(keys.gen_key_switching_key_raw(gen, sk, p))
    lv1 = jnp.asarray(_u32.to_numpy(sk.lv1))
    bits = np.tile([0, 1], 8).astype(np.uint32)
    ct1 = np.asarray(_jit(jtlwe.encrypt_binary, jp.replace(n=jp.N))(
        jax.random.PRNGKey(41), lv1, jnp.asarray(bits)))
    m = jget_engine("matmul")
    want = np.asarray(jax.jit(functools.partial(jbootstrap.identity_key_switch, params=jp,
                                                engine=m))(
        jnp.asarray(ct1), _jit(m.prepare_ksk, jp)(jnp.asarray(ksk_raw))))

    got = bootstrap.identity_key_switch(
        _u32.from_numpy(ct1), plain.prepare_ksk(_u32.from_numpy(ksk_raw), p), p)
    assert np.array_equal(_u32.to_numpy(got), want)
    assert tlwe.decrypt_binary(got, sk.lv0).numpy().tolist() == bits.tolist()


def test_default_params_match_reference():
    # SURVEY.md section 2.5's compatibility contract, on the port's preset.
    d = DEFAULT_PARAMS
    assert d.n == 635
    assert d.N == 1024 and d.nbit == 10
    assert d.bgbit == 6 and d.l == 3
    assert d.iks_basebit == 2 and d.iks_l == 8 and d.iks_t == 4
    assert d.alpha_lv0 == 2.0**-15 and d.alpha_lv1 == 2.0**-25
    assert d.mu == 1 << 29
    assert d == TFHEParams() and jparams.DEFAULT_PARAMS == jparams.TFHEParams()
