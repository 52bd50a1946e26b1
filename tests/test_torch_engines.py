"""The port's two engines against the JAX package: the selection rule, the
bootstrap through the limb engine, and the context and keys that carry an
engine.

Shared keys: the JAX package's raw keys cross into the port through
``keys.from_jax_keys``, so both packages bootstrap the same pre-combined
ciphertexts and must agree word for word (tolerance zero).  The port's
own keygen is held to correct decryption.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import engine as jengine
from rustfhe_tpu import gates as jgates
from rustfhe_tpu import keys as jkeys
from rustfhe_tpu import params as jparams
from rustfhe_tpu import tlwe as jtlwe
from rustfhe_tpu.engine.pallas_step import PallasEngine
from rustfhe_tpu_torch import TFHE, _u32, engine, gates, keys, params, tlwe
from rustfhe_tpu_torch.engine import LimbEngine, limb_step, plain
from rustfhe_tpu_torch.keys import LimbBK
from rustfhe_tpu_torch.utils import serialization as ser

# A small FAST_PARAMS-shaped set: 2 levels of base 2^8, n and N cut.
P_FAST = params.FAST_PARAMS.replace(n=16, N=128)
J_FAST = jparams.FAST_PARAMS.replace(n=16, N=128)
LIMB_FORMS = {
    "K4": LimbEngine(),
    "K6": LimbEngine(merge_c=False),
    "K5 per step": LimbEngine(fuse_step=False),
}


# --------------------------------------------------------------------- #
# The selection rule
# --------------------------------------------------------------------- #
class _Accelerator:
    platform = "tpu"


class _OnAccelerator:
    """Stands in for ``jax.numpy`` inside ``select_fast_engine``, so that its
    platform check reads an accelerator and its cascade runs as on a TPU."""

    asarray = staticmethod(jnp.asarray)

    @staticmethod
    def ones(*_args, **_kwargs):
        return SimpleNamespace(devices=lambda: {_Accelerator()})


class _NoOracle:
    """The probe verdicts are stubbed, so the oracle's output is not read."""

    def prepare_trgsw(self, rows, params_):
        return rows

    def external_product_digits(self, prepared, digits, params_):
        return np.zeros(1, np.uint32)


def _jax_cascade(jp, monkeypatch):
    """The engine JAX's ``select_fast_engine`` picks for ``jp`` on an
    accelerator where every candidate is exact: the first whose
    constraints the parameters meet."""
    monkeypatch.delenv("RUSTFHE_ENGINE", raising=False)
    monkeypatch.setattr(jengine, "jnp", _OnAccelerator)
    monkeypatch.setattr(jengine, "engine_exact_on_probe", lambda *_: True)
    monkeypatch.setitem(jengine._ENGINES, "oracle", _NoOracle())
    return jengine.select_fast_engine(jp)


# The JAX engines each port engine stands for.
FAMILY = {"pallas_k2": "cmux_k", "pallas_k": "cmux_k", "pallas": "limb"}


@pytest.mark.parametrize("name,want", [
    ("DEFAULT_PARAMS", "cmux_k"), ("N2048_PARAMS", "cmux_k"), ("PBS_PARAMS", "cmux_k"),
    ("PBS_TEST_PARAMS", "cmux_k"), ("FAST_PARAMS", "limb"),
])
def test_engine_rule_matches_jax_cascade(name, want, monkeypatch):
    assert FAMILY[_jax_cascade(getattr(jparams, name), monkeypatch)] == want
    assert engine.engine_for(getattr(params, name)) == want


def test_bgbit_9_raises_where_jax_falls_through_to_matmul(monkeypatch):
    assert _jax_cascade(jparams.TFHEParams(bgbit=9, l=2), monkeypatch) == "matmul"
    p = params.TFHEParams(bgbit=9, l=2)
    with pytest.raises(ValueError, match="'matmul' engine"):
        engine.engine_for(p)
    with pytest.raises(ValueError, match="'matmul' engine"):
        engine.select_engine(p, "cpu")


def test_selection_on_cpu_and_explicit_names():
    # N=64 is below the TPU kernels' tiling; the port's kernels take it.
    assert engine.select_engine(params.TEST_PARAMS, "cpu") == "cmux_k"
    assert engine.select_engine(P_FAST, "cpu") == "limb"
    assert engine.select_engine(P_FAST, "cpu", "cmux_k") == "cmux_k"
    assert engine.select_engine(params.TEST_PARAMS, "cpu", "limb") == "limb"
    assert engine.select_engine(params.TEST_PARAMS, "cpu", LimbEngine(merge_c=False)) == "limb"
    assert engine.resolve_engine("limb") is engine.get_engine("limb")
    with pytest.raises(KeyError, match="unknown engine"):
        engine.select_engine(params.TEST_PARAMS, "cpu", "pallas")


def test_inexact_limb_probe_raises(monkeypatch):
    real = limb_step.external_product

    def broken(digits, table, params_):
        out = real(digits, table, params_)
        out[0, 0, 0] += 1
        return out

    monkeypatch.setattr(limb_step, "external_product", broken)
    with pytest.raises(RuntimeError, match="limb engine's external product on cpu failed"):
        engine.select_engine(P_FAST, "cpu")
    with pytest.raises(RuntimeError, match="failed the oracle probe"):
        TFHE.new(0, P_FAST, device="cpu")
    assert engine.select_engine(P_FAST, "cpu", "cmux_k") == "cmux_k"


# --------------------------------------------------------------------- #
# The bootstrap through the limb engine, against JAX
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _jax_keys(seed=3):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    sk = jkeys.gen_secret_key(k1, J_FAST)
    bk_raw, ksk_raw = jkeys.gen_cloud_key_raw(k2, sk, J_FAST, "matmul")
    return tuple(np.asarray(x) for x in (sk.lv0, sk.lv1, bk_raw, ksk_raw))


@functools.lru_cache(maxsize=None)
def _jax_nand_batch(batch=16, seed=4):
    """Pre-combined NAND lanes over the four input pairs, encrypted by JAX."""
    lv0 = jnp.asarray(_jax_keys()[0])
    bx = np.tile([0, 1, 0, 1], batch // 4).astype(np.uint32)
    by = np.tile([0, 0, 1, 1], batch // 4).astype(np.uint32)
    kx, ky = jax.random.split(jax.random.PRNGKey(seed))
    cx = jtlwe.encrypt_binary(kx, lv0, jnp.asarray(bx), J_FAST)
    cy = jtlwe.encrypt_binary(ky, lv0, jnp.asarray(by), J_FAST)
    pre = np.asarray(jgates.precombine("nand", cx, cy, params=J_FAST))
    return pre, 1 - (bx & by)


def _jax_bootstrap(jeng):
    _, _, bk_raw, ksk_raw = _jax_keys()
    jck = jkeys.CloudKey(bk=jeng.prepare_trgsw(jnp.asarray(bk_raw), J_FAST),
                         ksk=jeng.prepare_ksk(jnp.asarray(ksk_raw), J_FAST))
    pre, _ = _jax_nand_batch()
    return np.asarray(jgates.hom_bootstrap(jck, jnp.asarray(pre), params=J_FAST,
                                           engine_name=jeng))


def _port_bootstrap(form):
    lv0, lv1, bk_raw, ksk_raw = _jax_keys()
    sk, ck = keys.from_jax_keys(lv0, lv1, bk_raw, ksk_raw, P_FAST, "cpu",
                                engine=LIMB_FORMS[form])
    assert isinstance(ck.bk, LimbBK)
    pre, want_bits = _jax_nand_batch()
    counts = (limb_step.cmux_step_merged.launches, limb_step.cmux_step_split.launches,
              limb_step.external_product.launches)
    out = gates.hom_bootstrap(ck, _u32.from_numpy(pre), params=P_FAST)
    assert counts == (limb_step.cmux_step_merged.launches, limb_step.cmux_step_split.launches,
                      limb_step.external_product.launches)  # CPU: plain versions only
    assert np.array_equal(tlwe.decrypt_binary(out, sk.lv0).numpy(), want_bits)
    return _u32.to_numpy(out)


@pytest.mark.parametrize("form", list(LIMB_FORMS))
def test_limb_bootstrap_matches_jax_matmul(form):
    assert np.array_equal(_port_bootstrap(form), _jax_bootstrap(jengine.get_engine("matmul")))


@pytest.mark.slow
@pytest.mark.parametrize("form", list(LIMB_FORMS))
def test_limb_bootstrap_matches_jax_pallas_interpret(form):
    jeng = PallasEngine(interpret=True, tb=8, merge_c=LIMB_FORMS[form].merge_c,
                        fuse_step=LIMB_FORMS[form].fuse_step)
    assert np.array_equal(_port_bootstrap(form), _jax_bootstrap(jeng))


def test_from_jax_keys_limb_table():
    lv0, lv1, bk_raw, ksk_raw = _jax_keys()
    _, ck = keys.from_jax_keys(lv0, lv1, bk_raw, ksk_raw, P_FAST, "cpu", engine="limb")
    _, ck_k1 = keys.from_jax_keys(lv0, lv1, bk_raw, ksk_raw, P_FAST, "cpu")
    want = np.asarray(jengine.get_engine("matmul").prepare_trgsw(jnp.asarray(bk_raw), J_FAST))
    N = P_FAST.N
    assert np.array_equal(ck.bk.table.numpy(),
                          np.concatenate([want[..., N:], want[..., :N]], axis=-1))
    assert ck.bk.merge_c and ck.bk.fuse_step
    assert torch.equal(ck.ksk, ck_k1.ksk)


# --------------------------------------------------------------------- #
# Context and keys
# --------------------------------------------------------------------- #
def _truth_tables(ctx):
    x, y = ctx.encrypt([0, 1, 0, 1]), ctx.encrypt([0, 0, 1, 1])
    assert ctx.decrypt(ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert ctx.decrypt(ctx.xor(x, y)).tolist() == [0, 1, 1, 0]
    assert ctx.decrypt(ctx.or_(x, y)).tolist() == [0, 1, 1, 1]


def test_context_picks_limb_at_fast_shape():
    ctx = TFHE.new(0, P_FAST, device="cpu")
    assert ctx.engine_name == "limb" and isinstance(ctx.ck.bk, LimbBK)
    assert ctx.ck.bk.table.shape == (P_FAST.n, 2 * P_FAST.l, 2, 4, 2 * P_FAST.N)
    _truth_tables(ctx)
    assert ctx.cloud_only().engine_name == "limb"


def test_context_limb_by_name_at_test_params():
    ctx = TFHE.new(1, params.TEST_PARAMS, device="cpu", engine_name="limb")
    assert ctx.engine_name == "limb" and isinstance(ctx.ck.bk, LimbBK)
    _truth_tables(ctx)
    split = TFHE.new(1, params.TEST_PARAMS, device="cpu",
                     engine_name=LimbEngine(merge_c=False))
    assert split.engine_name == "limb" and not split.ck.bk.merge_c
    # the same seed draws the same keys for either engine
    assert torch.equal(split.ck.bk.table, ctx.ck.bk.table)
    k1 = TFHE.new(1, params.TEST_PARAMS, device="cpu")
    assert k1.engine_name == "cmux_k"
    assert torch.equal(plain.prepare_trgsw_limbs(k1.ck.bk[..., params.TEST_PARAMS.N:]),
                       ctx.ck.bk.table)


def test_latency_mode_leaves_the_limb_key_unchanged():
    ctx = TFHE.new(2, P_FAST, device="cpu", latency_mode=True)
    assert ctx.engine_name == "limb" and isinstance(ctx.ck.bk, LimbBK)
    assert keys.cloud_key_latency(ctx.ck) is ctx.ck
    x = ctx.encrypt([0, 1])
    assert ctx.decrypt(ctx.not_(x)).tolist() == [1, 0]


def test_one_npz_serves_both_engines(tmp_path):
    prefix = str(tmp_path / "kc")
    sk, ck = ser.cached_keys(prefix, 5, P_FAST, device="cpu")
    sk_l, ck_l = ser.cached_keys(prefix, 6, P_FAST, device="cpu", engine="limb")
    assert torch.equal(sk.lv0, sk_l.lv0) and isinstance(ck_l.bk, LimbBK)
    ck_s, p_loaded = ser.load_cloud_key(f"{prefix}.ck.npz", device="cpu",
                                        engine=LimbEngine(fuse_step=False))
    assert p_loaded == P_FAST and not ck_s.bk.fuse_step
    assert torch.equal(ck_s.bk.table, ck_l.bk.table)
    gen = torch.Generator().manual_seed(7)
    bits = torch.tensor([0, 1, 1, 0, 1], dtype=torch.int32)
    pre = gates.precombine("not", tlwe.encrypt_binary(gen, sk.lv0, bits, P_FAST), params=P_FAST)
    outs = [gates.hom_bootstrap(c, pre, params=P_FAST) for c in (ck, ck_l, ck_s)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert tlwe.decrypt_binary(outs[0], sk.lv0).tolist() == [1, 0, 0, 1, 0]
    ctx = TFHE.new(8, P_FAST, device="cpu", keyfile=prefix)
    assert ctx.engine_name == "limb" and torch.equal(ctx.ck.bk.table, ck_l.bk.table)
