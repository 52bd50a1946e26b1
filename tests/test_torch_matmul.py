"""The port's generic dense-matmul engines ``"matmul"`` and ``"matmul_bf16"``
(``engine/matmul.py``) against the JAX package's ``MatmulEngine``, and the
bootstrap through them against JAX's.

Everything is word for word (tolerance zero): the same numpy-seeded inputs
(``probe_vectors`` and random words) go through both packages.  On the CPU
the "matmul" engine's GEMM is ``int8_gemm.int8_matmul``'s plain version and
"matmul_bf16"'s a float64 product of the same integers; the card's kernels
are held to them in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import functools

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
from rustfhe_tpu_torch import TFHE, _u32, engine, gates, keys, params, tlwe
from rustfhe_tpu_torch.engine import int8_gemm, oracle, plain
from rustfhe_tpu_torch.engine.matmul import MatmulEngine, circulant
from rustfhe_tpu_torch.keys import GenericBK
from rustfhe_tpu_torch.utils import serialization as ser

ENGINES = ["matmul", "matmul_bf16"]
# TEST_PARAMS, and one DEFAULT-width case cut to l=1.
SETS = {"TEST_PARAMS": (params.TEST_PARAMS, jparams.TEST_PARAMS),
        "DEFAULT_l1": (params.DEFAULT_PARAMS.replace(l=1), jparams.DEFAULT_PARAMS.replace(l=1))}


def _words(rs, shape):
    return rs.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _inputs(p, seed, batch=5):
    """(probe rows, probe digits), (random rows, random digits with the
    extremes -half_bg and half_bg - 1)."""
    rs = np.random.RandomState(seed)
    rows = _words(rs, (2 * p.l, 2, p.N))
    digits = rs.randint(-p.half_bg, p.half_bg, size=(batch, 2 * p.l, p.N)).astype(np.int32)
    digits[0, 0, :2] = [-p.half_bg, p.half_bg - 1]
    return engine.probe_vectors(p), (rows, digits)


@pytest.mark.parametrize("name", ENGINES)
@pytest.mark.parametrize("pset", list(SETS))
def test_external_product_matches_jax(name, pset):
    p, jp = SETS[pset]
    eng, jeng = engine.get_engine(name), jengine.get_engine(name)
    for rows, digits in _inputs(p, 1):
        prep = eng.prepare_trgsw(_u32.from_numpy(rows), p)
        jprep = np.asarray(jeng.prepare_trgsw(jnp.asarray(rows), jp))
        assert prep.dtype == torch.int8 and np.array_equal(prep.numpy(), jprep)
        got = eng.external_product_digits(prep, torch.from_numpy(digits), p)
        want = np.asarray(jeng.external_product_digits(jnp.asarray(jprep), jnp.asarray(digits),
                                                       jp))
        assert np.array_equal(_u32.to_numpy(got), want)
        assert torch.equal(got, oracle.external_product(_u32.from_numpy(rows),
                                                        torch.from_numpy(digits)))


@pytest.mark.parametrize("name", ENGINES)
def test_poly_mul_and_key_switch_match_jax(name):
    p, jp = SETS["TEST_PARAMS"]
    eng, jeng = engine.get_engine(name), jengine.get_engine(name)
    rs = np.random.RandomState(2)
    a = _words(rs, (3, p.N))
    a[0, :4] = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    s = rs.randint(0, 2, size=p.N).astype(np.uint32)
    got = eng.poly_mul_torus_binary(_u32.from_numpy(a), torch.from_numpy(s.astype(np.int32)), p)
    want = np.asarray(jeng.poly_mul_torus_binary(jnp.asarray(a), jnp.asarray(s), jp))
    assert np.array_equal(_u32.to_numpy(got), want)
    assert torch.equal(got, plain.poly_mul_torus_binary(_u32.from_numpy(a),
                                                        torch.from_numpy(s.astype(np.int32))))
    ksk_raw = _words(rs, (p.N, p.iks_l, p.iks_t, p.n + 1))
    ksk = eng.prepare_ksk(_u32.from_numpy(ksk_raw), p)
    jksk = np.asarray(jeng.prepare_ksk(jnp.asarray(ksk_raw), jp))
    assert np.array_equal(ksk.numpy(), jksk)
    digits = rs.randint(0, p.iks_t, size=(4, p.N, p.iks_l)).astype(np.int32)
    got = eng.key_switch_digits(ksk, torch.from_numpy(digits), p)
    want = np.asarray(jeng.key_switch_digits(jnp.asarray(jksk), jnp.asarray(digits), jp))
    assert np.array_equal(_u32.to_numpy(got), want)
    # and the port's float64 switch, which the bootstrap runs
    assert torch.equal(got, plain.key_switch_digits(plain.prepare_ksk(_u32.from_numpy(ksk_raw),
                                                                      p),
                                                    torch.from_numpy(digits), p))


def test_circulant_layout_and_padding():
    # wt[(c, k, n), (j, m')] = table[j, c, k, (n - (N-1-m')) mod 2N]: the
    # circulant of the JAX engine (C[(j, m), (c, k, n)]) with the digits reversed.
    p = params.TEST_PARAMS.replace(l=1, N=32)
    eng = MatmulEngine()
    rs = np.random.RandomState(3)
    rows = _u32.from_numpy(_words(rs, (2, 2, p.N)))
    table = eng.prepare_trgsw(rows, p)
    wt = circulant(table)
    N = p.N
    assert wt.shape == (2 * 4 * N, 2 * N) and wt.is_contiguous()
    c, k, n, j, m = np.meshgrid(np.arange(2), np.arange(4), np.arange(N), np.arange(2),
                                np.arange(N), indexing="ij")
    want = table.numpy()[j, c, k, (n - (N - 1 - m)) % (2 * N)].reshape(wt.shape)
    assert np.array_equal(wt.numpy(), want)
    # 2L*N = 64 is one GEMM slice; 3 rows pad to the 128-row tile and the pad
    # does not reach the output
    d = torch.from_numpy(rs.randint(-32, 32, size=(3, 2, N)).astype(np.int32))
    before = int8_gemm.int8_matmul.launches
    got = eng.external_product_digits(table, d, p)
    assert int8_gemm.int8_matmul.launches == before  # the CPU runs the plain version
    assert torch.equal(got, oracle.external_product(rows, d))


# --------------------------------------------------------------------- #
# The bootstrap at TEST_PARAMS against JAX's
# --------------------------------------------------------------------- #
P, JP = params.TEST_PARAMS, jparams.TEST_PARAMS


@functools.lru_cache(maxsize=None)
def _jax_keys(seed=5):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    sk = jkeys.gen_secret_key(k1, JP)
    bk_raw, ksk_raw = jkeys.gen_cloud_key_raw(k2, sk, JP, "matmul")
    return tuple(np.asarray(x) for x in (sk.lv0, sk.lv1, bk_raw, ksk_raw))


@functools.lru_cache(maxsize=None)
def _jax_nand_batch(batch=8, seed=6):
    lv0 = jnp.asarray(_jax_keys()[0])
    bx = np.tile([0, 1, 0, 1], batch // 4).astype(np.uint32)
    by = np.tile([0, 0, 1, 1], batch // 4).astype(np.uint32)
    kx, ky = jax.random.split(jax.random.PRNGKey(seed))
    cx = jtlwe.encrypt_binary(kx, lv0, jnp.asarray(bx), JP)
    cy = jtlwe.encrypt_binary(ky, lv0, jnp.asarray(by), JP)
    return np.asarray(jgates.precombine("nand", cx, cy, params=JP)), 1 - (bx & by)


@functools.lru_cache(maxsize=None)
def _jax_bootstrap(name):
    _, _, bk_raw, ksk_raw = _jax_keys()
    jeng = jengine.get_engine(name)
    jck = jkeys.CloudKey(bk=jeng.prepare_trgsw(jnp.asarray(bk_raw), JP),
                         ksk=jeng.prepare_ksk(jnp.asarray(ksk_raw), JP))
    pre, _ = _jax_nand_batch()
    return np.asarray(jgates.hom_bootstrap(jck, jnp.asarray(pre), params=JP, engine_name=name))


@pytest.mark.parametrize("name", ENGINES)
def test_bootstrap_matches_jax(name):
    lv0, lv1, bk_raw, ksk_raw = _jax_keys()
    sk, ck = keys.from_jax_keys(lv0, lv1, bk_raw, ksk_raw, P, "cpu", engine=name)
    assert isinstance(ck.bk, GenericBK) and ck.bk.engine == name
    pre, want_bits = _jax_nand_batch()
    out = gates.hom_bootstrap(ck, _u32.from_numpy(pre), params=P)
    assert np.array_equal(_u32.to_numpy(out), _jax_bootstrap(name))
    assert np.array_equal(tlwe.decrypt_binary(out, sk.lv0).numpy(), want_bits)


def test_from_jax_keys_takes_jax_matmul_table():
    lv0, lv1, bk_raw, ksk_raw = _jax_keys()
    jtab = np.asarray(jengine.get_engine("matmul").prepare_trgsw(jnp.asarray(bk_raw), JP))
    _, ck = keys.from_jax_keys(lv0, lv1, bk_raw, ksk_raw, P, "cpu", engine="matmul",
                               bk_table=jtab)
    _, own = keys.from_jax_keys(lv0, lv1, bk_raw, ksk_raw, P, "cpu", engine="matmul")
    assert np.array_equal(ck.bk.table.numpy(), jtab) and torch.equal(ck.bk.table, own.bk.table)
    pre, _ = _jax_nand_batch()
    out = gates.hom_bootstrap(ck, _u32.from_numpy(pre), params=P)
    assert np.array_equal(_u32.to_numpy(out), _jax_bootstrap("matmul"))
    with pytest.raises(ValueError, match="must be int8"):
        keys.from_jax_keys(lv0, lv1, bk_raw, ksk_raw, P, "cpu", engine="matmul",
                           bk_table=jtab[:1])
    with pytest.raises(ValueError, match="matmul engine's table"):
        keys.from_jax_keys(lv0, lv1, bk_raw, ksk_raw, P, "cpu", bk_table=jtab)


def test_context_runs_the_generic_engines():
    # TEST_PARAMS (N=64) picks "matmul" by the JAX rule; the latency mark
    # leaves a generic key as it is; every engine name draws the same keys.
    ctx = TFHE.new(3, P, device="cpu", latency_mode=True)
    assert ctx.engine_name == "matmul" and isinstance(ctx.ck.bk, GenericBK)
    assert keys.cloud_key_latency(ctx.ck) is ctx.ck
    x, y = ctx.encrypt([0, 1, 0, 1]), ctx.encrypt([0, 0, 1, 1])
    before = int8_gemm.int8_matmul.launches
    assert ctx.decrypt(ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert int8_gemm.int8_matmul.launches == before  # the CPU runs the plain version
    for name in ("matmul_bf16", "fft64"):
        other = TFHE.new(3, P, device="cpu", engine_name=name)
        assert other.ck.bk.engine == name and torch.equal(other.sk.lv0, ctx.sk.lv0)
        assert torch.equal(gates.hom_bootstrap(other.ck, gates.precombine("nand", x, y, params=P),
                                               params=P), ctx.nand(x, y))
    with pytest.raises(ValueError, match="nuss engine builds its key tables host-side"):
        TFHE.new(3, P, device="cpu", engine_name="nuss")


def test_bgbit_9_runs_on_matmul_bf16():
    # Digits up to 256: the int8 engines cannot hold them; the rule names
    # "matmul_bf16", and a mixed batch decrypts right.
    p = P.replace(bgbit=9, l=2)
    ctx = TFHE.new(4, p, device="cpu")
    assert ctx.engine_name == "matmul_bf16"
    x, y = ctx.encrypt([0, 1, 0, 1]), ctx.encrypt([0, 0, 1, 1])
    assert ctx.decrypt(ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert ctx.decrypt(ctx.xor(x, y)).tolist() == [0, 1, 1, 0]
    assert ctx.decrypt(ctx.not_(x)).tolist() == [1, 0, 1, 0]


def test_npz_keys_serve_the_generic_engines(tmp_path):
    prefix = str(tmp_path / "kc")
    sk, ck = ser.cached_keys(prefix, 9, P, device="cpu", engine="matmul")
    assert isinstance(ck.bk, GenericBK) and ck.bk.engine == "matmul"
    ck_b, p_loaded = ser.load_cloud_key(f"{prefix}.ck.npz", device="cpu", engine="matmul_bf16")
    assert p_loaded == P and ck_b.bk.engine == "matmul_bf16"
    ck_k, _ = ser.load_cloud_key(f"{prefix}.ck.npz", device="cpu")
    gen = torch.Generator().manual_seed(10)
    bits = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    pre = gates.precombine("not", tlwe.encrypt_binary(gen, sk.lv0, bits, P), params=P)
    outs = [gates.hom_bootstrap(c, pre, params=P) for c in (ck, ck_b, ck_k)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert tlwe.decrypt_binary(outs[0], sk.lv0).tolist() == [0, 1, 0, 0]
