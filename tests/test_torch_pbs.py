"""The port's programmable bootstrapping (``pbs.py``) against the JAX
package's: the 18 cases of ``tests/test_pbs.py`` replayed on the port,
then the blind rotation with a test vector per row.

The JAX package's raw keys at TEST_PARAMS are carried across
(``keys.from_jax_keys``; the port prepares them for ``"matmul"``, which
``engine_for`` names at N=64, the JAX side runs ``engine_name="matmul"``),
and the ciphertexts are JAX encryptions carried across as uint32 words, so
every output is deterministic: ``pbs``, ``pbs_many`` (t = 1, 2, 4), per-row
tables, ``raw=True`` and ``from_pbs_int`` must equal JAX's lv0 words word
for word (tolerance zero), and the codec and test vectors must equal JAX's
exactly.  Every port call must leave its operands as they were.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import bootstrap as jbootstrap
from rustfhe_tpu import context as jcontext
from rustfhe_tpu import keys as jkeys
from rustfhe_tpu import pbs as jpbs
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.params import DEFAULT_PARAMS as J_DEFAULT
from rustfhe_tpu.params import PBS_TEST_PARAMS as J_PBS_TEST
from rustfhe_tpu.params import TEST_PARAMS as J_TEST
from rustfhe_tpu_torch import TFHE, _u32, bootstrap, keys, params, pbs
from rustfhe_tpu_torch.engine import cmux_k, rotate_all_k

U32 = jnp.uint32
SPACE = 4  # at TEST_PARAMS (N=64, n=16) the bucket margin is ~6.6 sigma


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops: one intra-op thread (idle OpenMP threads of parallel
    test workers spin on the cores the others need)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_keys(seed, jp):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jsk = jkeys.gen_secret_key(k1, jp)
    bk_raw, ksk_raw = jkeys.gen_cloud_key_raw(k2, jsk, jp, "matmul")
    m = get_engine("matmul")
    jck = jkeys.CloudKey(bk=m.prepare_trgsw(bk_raw, jp), ksk=m.prepare_ksk(ksk_raw, jp))
    raw = [np.asarray(x) for x in (jsk.lv0, jsk.lv1, bk_raw, ksk_raw)]
    return jsk, jck, raw


@pytest.fixture(scope="module")
def setup():
    """(port context, JAX context, JAX encryption key), one key set."""
    jsk, jck, raw = _jax_keys(11, J_TEST)
    sk, ck = keys.from_jax_keys(*raw, params.TEST_PARAMS, "cpu", engine="matmul")
    ctx = TFHE(sk, ck, params.TEST_PARAMS, "cpu", torch.Generator().manual_seed(12), "matmul")
    jctx = jcontext.TFHE(jsk, jck, J_TEST, "matmul")
    jctx._enc_key = jax.random.PRNGKey(13)
    return ctx, jctx, jax.random.PRNGKey(14)


def _t(a):
    return _u32.from_numpy(np.asarray(a))


def _np(t):
    return _u32.to_numpy(t)


def enc(setup, xs, space, salt):
    """(port words, JAX words) of a JAX encryption of ``xs``."""
    _, jctx, ke = setup
    j = jpbs.encrypt_int(jax.random.fold_in(ke, salt), jctx.sk.lv0, jnp.asarray(xs, U32),
                         space, J_TEST)
    return _t(j), j


@contextlib.contextmanager
def unchanged(*tensors):
    before = [t.clone() for t in tensors]
    yield
    for t, b in zip(tensors, before):
        assert torch.equal(t, b), "a call wrote into its operand"


def same(got, want):
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), np.asarray(want))


def dec(ctx, ct, space):
    return pbs.decrypt_int(ct, ctx.sk.lv0, space).numpy()


# --------------------------- codec exactness --------------------------- #
def test_encode_decode_roundtrip_exact():
    for space in (2, 4, 8, 64):
        xs = np.arange(2 * space, dtype=np.uint32)
        enc_ = pbs.encode_int(xs, space)
        assert enc_.dtype == torch.int32
        assert np.array_equal(_np(enc_), np.asarray(jpbs.encode_int(jnp.asarray(xs), space)))
        assert np.array_equal(
            _np(enc_),
            (np.arange(2 * space, dtype=np.uint64) * ((1 << 32) // (2 * space))).astype(np.uint32))
        assert np.array_equal(pbs.decode_int(enc_, space).numpy(), xs)


def test_decode_tolerates_noise_within_half_bucket():
    space = 4
    enc_ = pbs.encode_int(np.arange(space), space)
    half = (1 << 32) // (4 * space)
    up = enc_ + _u32.s32(half - 1)
    down = enc_ - half
    assert np.array_equal(pbs.decode_int(up, space).numpy(), np.arange(space))
    assert np.array_equal(pbs.decode_int(down, space).numpy(), np.arange(space))
    for w in (up, down):  # against JAX on the same words
        assert np.array_equal(pbs.decode_int(w, space).numpy(),
                              np.asarray(jpbs.decode_int(jnp.asarray(_np(w)), space)))
    z = pbs.decode_int(pbs.encode_int(0, space) - half, space)
    assert int(z) == 0  # 0 minus noise decodes back to 0, not to the top bucket


def test_encode_wraps_mod_2space():
    space = 4
    assert int(pbs.encode_int(-1, space)) == int(pbs.encode_int(2 * space - 1, space))
    vals = np.array([-1, -9, 7, 8, 2**31 + 3, 2**40 + 5], np.int64)
    assert np.array_equal(_np(pbs.encode_int(vals, space)),
                          np.asarray(jpbs.encode_int(jnp.asarray(vals.astype(np.uint32)), space)))
    t = torch.tensor([-1, 5, 12], dtype=torch.int32)
    assert np.array_equal(_np(pbs.encode_int(t, space)), _np(pbs.encode_int([7, 5, 4], space)))


def test_space_validation():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):
        pbs.encrypt_int(g, torch.zeros(16, dtype=torch.int32), 0, 3, params.TEST_PARAMS)
    with pytest.raises(ValueError):
        pbs.lut_testvec(np.zeros((4,)), 4, params.TEST_PARAMS.replace(N=2))
    with pytest.raises(ValueError):
        pbs.lut_testvec(np.zeros((8,)), 4, params.TEST_PARAMS)  # table/space mismatch


# ----------------------- encrypted round trips ------------------------- #
def test_encrypt_decrypt_int_roundtrip(setup):
    ctx, jctx, _ = setup
    xs = np.arange(SPACE, dtype=np.uint32)
    ct, jct = enc(setup, xs, SPACE, 0)
    assert np.array_equal(dec(ctx, ct, SPACE), xs)
    assert np.array_equal(dec(ctx, ct, SPACE),
                          np.asarray(jpbs.decrypt_int(jct, jctx.sk.lv0, SPACE)))
    own = pbs.encrypt_int(ctx.gen, ctx.sk.lv0, xs, SPACE, ctx.params)  # the port's own draws
    assert own.shape == (SPACE, ctx.params.n + 1) and own.dtype == torch.int32
    assert np.array_equal(dec(ctx, own, SPACE), xs)


def test_lut_testvec_staircase():
    p = params.TEST_PARAMS
    table = np.array([3, 0, 2, 1], np.uint32)
    tv = pbs.lut_testvec(table, 4, p)
    assert tv.shape == (2, p.N)
    want = np.repeat(_np(pbs.encode_int(table, 4)), p.N // 4)
    assert np.array_equal(_np(tv[0]), want) and not tv[1].any()
    assert np.array_equal(_np(tv), np.asarray(jpbs.lut_testvec(jnp.asarray(table), 4, J_TEST)))
    rs = np.random.RandomState(5)
    per_row = rs.randint(0, 8, size=(3, 2, 4))
    assert np.array_equal(_np(pbs.lut_testvec(per_row, 4, p)),
                          np.asarray(jpbs.lut_testvec(jnp.asarray(per_row), 4, J_TEST)))
    raw = rs.randint(0, 2**32, size=(5, 4), dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(_np(pbs.lut_testvec(raw, 4, p, raw=True)),
                          np.asarray(jpbs.lut_testvec(jnp.asarray(raw), 4, J_TEST, raw=True)))
    for space, t in ((2, 4), (4, 2), (8, 1), (2, 2)):
        tabs = rs.randint(0, 2**32, size=(3, t, space), dtype=np.uint64).astype(np.uint32)
        for is_raw in (False, True):
            assert np.array_equal(
                _np(pbs.many_lut_testvec(tabs, space, p, raw=is_raw)),
                np.asarray(jpbs.many_lut_testvec(jnp.asarray(tabs), space, J_TEST, raw=is_raw)))


# --------------------------- end-to-end PBS ---------------------------- #
def test_pbs_arbitrary_table(setup):
    ctx, jctx, _ = setup
    table = np.array([2, 0, 3, 3], np.uint32)  # arbitrary, non-monotone, repeats
    xs = np.tile(np.arange(SPACE, dtype=np.uint32), 4)
    ct, jct = enc(setup, xs, SPACE, 1)
    with unchanged(ct):
        out = pbs.pbs(ctx.ck, ct, table, space=SPACE, params=ctx.params)
    assert out.shape == ct.shape
    same(out, jpbs.pbs(jctx.ck, jct, jnp.asarray(table), space=SPACE, params=J_TEST,
                       engine_name="matmul"))
    assert np.array_equal(dec(ctx, out, SPACE), table[xs])


def test_pbs_multi_lut_per_row(setup):
    """A different function per batch row in one bootstrap."""
    ctx, jctx, _ = setup
    rng = np.random.default_rng(3)
    tables = rng.integers(0, SPACE, size=(8, SPACE)).astype(np.uint32)
    xs = rng.integers(0, SPACE, size=(8,)).astype(np.uint32)
    ct, jct = enc(setup, xs, SPACE, 2)
    tt = torch.from_numpy(tables.astype(np.int64))
    with unchanged(ct, tt):
        out = pbs.pbs(ctx.ck, ct, tt, space=SPACE, params=ctx.params)
    same(out, jpbs.pbs(jctx.ck, jct, jnp.asarray(tables), space=SPACE, params=J_TEST,
                       engine_name="matmul"))
    assert np.array_equal(dec(ctx, out, SPACE), tables[np.arange(8), xs])


def test_pbs_chains_and_resets_noise(setup):
    ctx, jctx, _ = setup
    f = np.array([1, 2, 3, 0], np.uint32)  # +1 mod 4
    g = np.array([0, 3, 2, 1], np.uint32)  # negate mod 4
    xs = np.arange(SPACE, dtype=np.uint32)
    ct, jct = enc(setup, xs, SPACE, 4)
    mid = pbs.pbs(ctx.ck, ct, f, space=SPACE, params=ctx.params)
    with unchanged(mid):
        out = pbs.pbs(ctx.ck, mid, g, space=SPACE, params=ctx.params)
    jmid = jpbs.pbs(jctx.ck, jct, jnp.asarray(f), space=SPACE, params=J_TEST,
                    engine_name="matmul")
    same(mid, jmid)
    same(out, jpbs.pbs(jctx.ck, jmid, jnp.asarray(g), space=SPACE, params=J_TEST,
                       engine_name="matmul"))
    assert np.array_equal(dec(ctx, out, SPACE), g[f[xs]])


def test_pbs_identity_refreshes(setup):
    ctx, jctx, _ = setup
    xs = np.arange(SPACE, dtype=np.uint32)
    ct, jct = enc(setup, xs, SPACE, 5)
    out = pbs.pbs(ctx.ck, ct, np.arange(SPACE), space=SPACE, params=ctx.params)
    same(out, jpbs.pbs(jctx.ck, jct, jnp.arange(SPACE, dtype=U32), space=SPACE, params=J_TEST,
                       engine_name="matmul"))
    assert np.array_equal(dec(ctx, out, SPACE), xs)


def test_context_apply_lut(setup):
    ctx, jctx, _ = setup
    table = [3, 1, 0, 2]
    xs = np.array([2, 0, 3, 1, 2], np.uint32)
    own = ctx.encrypt_int(xs, SPACE)  # the port's own encryption: decrypt-correct
    assert np.array_equal(ctx.decrypt_int(own, SPACE).numpy(), xs)
    assert np.array_equal(ctx.decrypt_int(ctx.apply_lut(own, table, SPACE), SPACE).numpy(),
                          np.asarray(table)[xs])
    ct, jct = enc(setup, xs, SPACE, 6)  # JAX's words: word for word
    same(ctx.apply_lut(ct, table, SPACE), jctx.apply_lut(jct, table, SPACE))
    cloud = ctx.cloud_only()
    with pytest.raises(ValueError, match="cloud-only"):
        cloud.encrypt_int(xs, SPACE)
    with pytest.raises(ValueError, match="cloud-only"):
        cloud.decrypt_int(ct, SPACE)
    same(cloud.apply_lut(ct, table, SPACE), jctx.apply_lut(jct, table, SPACE))


# -------------------------- noise-space check -------------------------- #
def test_check_pbs_space_defaults():
    from rustfhe_tpu_torch.utils.noise import DEFAULT_SIGMA_INFLATION, noise_budget

    p = params.DEFAULT_PARAMS
    ok4, msg4 = pbs.check_pbs_space(p, 4)
    ok8, msg8 = pbs.check_pbs_space(p, 8)
    ok16, msg16 = pbs.check_pbs_space(p, 16)
    assert ok4, msg4
    assert not ok8, msg8
    assert not ok16, msg16
    m8 = (1.0 / 32.0) / (noise_budget(p).sigma_total * DEFAULT_SIGMA_INFLATION)
    assert 2.5 < m8 < 3.3, m8
    assert f"{m8:.1f}" in msg8
    for space, got in ((4, (ok4, msg4)), (8, (ok8, msg8)), (16, (ok16, msg16))):
        assert got == jpbs.check_pbs_space(J_DEFAULT, space)


# ------------------------- multi-output PBS ---------------------------- #
def test_pbs_many_lut(setup):
    """t=4 lookup tables, one blind rotation: every row j decodes to
    tables[j][x] and equals JAX's words."""
    ctx, jctx, _ = setup
    space, t = 2, 4
    rs = np.random.RandomState(17)
    xs = rs.randint(0, space, size=12)
    tables = rs.randint(0, space, size=(t, space))
    ct, jct = enc(setup, xs, space, 31)
    with unchanged(ct):
        out = pbs.pbs_many(ctx.ck, ct, tables, space=space, params=ctx.params, unsafe=True)
    assert out.shape == (12, t, ctx.params.n + 1)
    same(out, jpbs.pbs_many(jctx.ck, jct, jnp.asarray(tables), space=space, params=J_TEST,
                            engine_name="matmul", unsafe=True))
    d = dec(ctx, out, space)
    for j in range(t):
        np.testing.assert_array_equal(d[:, j], tables[j][xs])
    # The rotation half alone (the coarse modulus switch, the t extractions).
    lv1 = pbs.rotate_extract_many(ctx.ck.bk, ct, tables, space, ctx.params)
    jlv1 = jpbs.rotate_extract_many(jctx.ck.bk, jct, jnp.asarray(tables), space, J_TEST,
                                    get_engine("matmul"))
    same(lv1, jlv1)


def test_pbs_many_t1_matches_pbs(setup):
    """t=1 is a plain PBS (no coarsening): word for word pbs()."""
    ctx, jctx, _ = setup
    xs = np.arange(SPACE, dtype=np.uint32)
    table = np.array([3, 0, 2, 1])
    ct, _ = enc(setup, xs, SPACE, 32)
    one = pbs.pbs(ctx.ck, ct, table, space=SPACE, params=ctx.params)
    many = pbs.pbs_many(ctx.ck, ct, table[None, :], space=SPACE, params=ctx.params)
    assert torch.equal(many[:, 0], one)


def test_pbs_many_per_row_tables(setup):
    """Leading table axes broadcast against the batch: a different
    t-tuple of functions per batch row (t=2)."""
    ctx, jctx, _ = setup
    space, t, B = 2, 2, 6
    rs = np.random.RandomState(23)
    xs = rs.randint(0, space, size=B)
    tables = rs.randint(0, space, size=(B, t, space))
    ct, jct = enc(setup, xs, space, 33)
    out = pbs.pbs_many(ctx.ck, ct, tables, space=space, params=ctx.params)
    same(out, jpbs.pbs_many(jctx.ck, jct, jnp.asarray(tables), space=space, params=J_TEST,
                            engine_name="matmul"))
    d = dec(ctx, out, space)
    for b in range(B):
        for j in range(t):
            assert d[b, j] == tables[b, j, xs[b]]


def test_check_pbs_many():
    p = params.DEFAULT_PARAMS
    ok2, msg2 = pbs.check_pbs_many(p, 2, 2)
    ok1, msg1 = pbs.check_pbs_many(p, 2, 1)
    m = lambda s: float(s.split("margin ")[1].split(" sigma")[0])  # noqa: E731
    assert m(msg1) > m(msg2)
    assert ok2, msg2
    with pytest.raises(ValueError):
        pbs.check_pbs_many(p, 2, 3)  # t not a power of two
    with pytest.raises(ValueError):
        pbs.check_pbs_many(params.TEST_PARAMS, 64, 2)  # space*t > N
    assert (ok1, msg1) == jpbs.check_pbs_many(J_DEFAULT, 2, 1)


def test_pbs_raw_matches_encoded(setup):
    """raw=True with pre-encoded torus words is word for word the
    integer-table path, and both equal JAX's; raw words >= 2^31 (-mu) come
    across from numpy uint32."""
    ctx, jctx, _ = setup
    xs = np.arange(SPACE, dtype=np.uint32)
    table = np.array([2, 0, 3, 1])
    ct, jct = enc(setup, xs, SPACE, 41)
    encoded = pbs.pbs(ctx.ck, ct, table, space=SPACE, params=ctx.params)
    raw = pbs.pbs(ctx.ck, ct, pbs.encode_int(table, SPACE), space=SPACE, params=ctx.params,
                  raw=True)
    assert torch.equal(encoded, raw)
    same(raw, jpbs.pbs(jctx.ck, jct, jpbs.encode_int(jnp.asarray(table), SPACE), space=SPACE,
                       params=J_TEST, engine_name="matmul", raw=True))
    mu = ctx.params.mu
    gate = np.array([mu, (-mu) & 0xFFFFFFFF, mu, (-mu) & 0xFFFFFFFF], np.uint32)
    same(pbs.pbs(ctx.ck, ct, gate, space=SPACE, params=ctx.params, raw=True),
         jpbs.pbs(jctx.ck, jct, jnp.asarray(gate), space=SPACE, params=J_TEST,
                  engine_name="matmul", raw=True))


def test_from_pbs_int_bridge(setup):
    """PBS-domain int -> FheUint bit planes in one bootstrap, word for word
    JAX's, composable with the integer API."""
    ctx, jctx, _ = setup
    space = 4
    xs = np.array([0, 1, 2, 3, 3, 1], np.uint32)
    ct, jct = enc(setup, xs, space, 42)
    # TEST_PARAMS scores below the 5-sigma bar: the bridge refuses...
    with pytest.raises(ValueError, match="margin below threshold"):
        ctx.int_to_uint(ct, space)
    # ...and runs under the explicit override.
    with unchanged(ct):
        u = ctx.int_to_uint(ct, space, unsafe=True)
    assert u.width == 2
    same(u.bits, jctx.int_to_uint(jct, space, unsafe=True).bits)
    np.testing.assert_array_equal(u.decrypt(), xs)
    np.testing.assert_array_equal((u + 1).decrypt(), (xs + 1) & 3)


# ---------------- the blind rotation, a test vector per row ---------------- #
@pytest.fixture(scope="module")
def pbs_test_keys():
    """JAX's raw keys at PBS_TEST_PARAMS (N=256, l=4), prepared for JAX's
    "matmul" and for the port's "cmux_k" (K1, and K3 on a latency key)."""
    jsk, jck, raw = _jax_keys(21, J_PBS_TEST)
    sk, ck = keys.from_jax_keys(*raw, params.PBS_TEST_PARAMS, "cpu")
    return jck, ck


def _rotation_inputs(seed, B, p):
    rs = np.random.RandomState(seed)
    ct = rs.randint(0, 2**32, size=(B, p.n + 1), dtype=np.uint64).astype(np.uint32)
    ct[:4, 0] = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF][:B]
    tv = rs.randint(0, 2**32, size=(B, 2, p.N), dtype=np.uint64).astype(np.uint32)
    return ct, tv


@pytest.mark.parametrize("B", [1, 5, rotate_all_k.MAX_BATCH + 3])
@pytest.mark.parametrize("key", ["cmux_k", "latency"])
def test_blind_rotate_test_vector_per_row(pbs_test_keys, key, B, monkeypatch):
    """``blind_rotate`` with a test vector per row (B, 2, N) equals the JAX
    function word for word on the K1 loop (K1's plain version) and on a
    latency key (K3's plain version at B <= MAX_BATCH, the K1 loop above);
    a leading axis (2, B/2) and a (2, N) vector broadcast as in JAX."""
    jck, ck = pbs_test_keys
    p, jp = params.PBS_TEST_PARAMS, J_PBS_TEST
    bk = keys.cloud_key_latency(ck).bk if key == "latency" else ck.bk
    ct, tv = _rotation_inputs(70 + B, B, p)
    want = np.asarray(jbootstrap.blind_rotate(jnp.asarray(ct), jck.bk, jnp.asarray(tv), jp,
                                              get_engine("matmul")))
    calls = {"K1": 0, "K3": 0}  # the wrappers' calls (on the CPU they run the plain versions)
    for mod, fn, name in ((cmux_k, "cmux_step", "K1"), (rotate_all_k, "rotate_all", "K3")):
        def counted(*a, _f=getattr(mod, fn), _n=name):
            calls[_n] += 1
            assert a[0].shape == (B, 2, p.N)  # the accumulator: one row per sample
            return _f(*a)
        monkeypatch.setattr(mod, fn, counted)
    t_ct, t_tv = _t(ct), _t(tv)
    with unchanged(t_ct, t_tv):
        got = bootstrap.blind_rotate(t_ct, bk, t_tv, p)
    assert np.array_equal(_np(got), want)
    on_k3 = key == "latency" and B <= rotate_all_k.MAX_BATCH
    assert calls == ({"K1": 0, "K3": 1} if on_k3 else {"K1": p.n, "K3": 0})
    monkeypatch.undo()
    if B % 2 == 0 or B == 1:
        return
    # One vector for every row, and per-row vectors under a leading axis.
    one = np.asarray(jbootstrap.blind_rotate(jnp.asarray(ct), jck.bk, jnp.asarray(tv[0]), jp,
                                             get_engine("matmul")))
    assert np.array_equal(_np(bootstrap.blind_rotate(t_ct, bk, t_tv[0], p)), one)
    lead = (1, B)
    got2 = bootstrap.blind_rotate(t_ct.reshape(lead + (p.n + 1,)), bk, t_tv[None], p)
    assert got2.shape == lead + (2, p.N) and np.array_equal(_np(got2[0]), want)


def test_pbs_per_row_tables_on_k1_and_k3(pbs_test_keys):
    """Radix-style levels at PBS_TEST_PARAMS: per-row space-8 tables
    through ``pbs`` on the K1 loop and on a latency key (K3) give the same
    words as JAX's pbs."""
    jck, ck = pbs_test_keys
    p, jp = params.PBS_TEST_PARAMS, J_PBS_TEST
    rs = np.random.RandomState(80)
    ct = rs.randint(0, 2**32, size=(3, 4, p.n + 1), dtype=np.uint64).astype(np.uint32)
    tables = rs.randint(0, 8, size=(3, 1, 8))
    want = np.asarray(jpbs.pbs(jck, jnp.asarray(ct), jnp.asarray(tables), space=8, params=jp,
                               engine_name="matmul"))
    for c in (ck, keys.cloud_key_latency(ck)):
        got = pbs.pbs(c, _t(ct), tables, space=8, params=p)
        assert np.array_equal(_np(got), want)
