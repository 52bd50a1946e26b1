"""The port's typed encrypted integers (``ints.FheUint`` / ``FheInt``)
against the JAX package's, on the cases of ``tests/test_ints.py``.

The JAX package's raw keys are carried across (``keys.from_jax_keys``), the
operands are encrypted in JAX and their uint32 words carried across, so
every op is deterministic: the port's output bits must equal JAX's word
for word (tolerance zero), and the decrypted values must equal the numpy
model.  Every op must leave its operands' bits as they were.  The JAX
context pads every circuit level to one width (``circuit_fixed_width``)
so that JAX compiles few programs; the port buckets its levels, and the
padding changes no output word.  Both adder families
(``circuit_adder``) run where they give different circuits.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import context as jcontext
from rustfhe_tpu import ints as jints
from rustfhe_tpu import keys as jkeys
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.params import TEST_PARAMS as J_TEST
from rustfhe_tpu_torch import TFHE, FheInt, FheUint, _u32, keys, params

W = 4
MASK = (1 << W) - 1
A_VALS = np.array([0, 1, 7, 11, 15, 9], np.uint64)
B_VALS = np.array([0, 15, 3, 11, 1, 2], np.uint64)
KINDS = ["kogge_stone", "ripple"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one intra-op thread each.  Under
    parallel test workers, torch's idle OpenMP threads spin on the cores
    the other workers need (4x slower with six busy processes on an 8-core
    CPU host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    jsk = jkeys.gen_secret_key(k1, J_TEST)
    bk_raw, ksk_raw = jkeys.gen_cloud_key_raw(k2, jsk, J_TEST, "matmul")
    m = get_engine("matmul")
    jck = jkeys.CloudKey(bk=m.prepare_trgsw(bk_raw, J_TEST), ksk=m.prepare_ksk(ksk_raw, J_TEST))
    jctx = jcontext.TFHE(jsk, jck, J_TEST, "matmul")
    jctx._enc_key = jax.random.PRNGKey(8)
    jctx.circuit_fixed_width = 16  # the widest level of every cell below
    sk, ck = keys.from_jax_keys(*(np.asarray(x) for x in (jsk.lv0, jsk.lv1, bk_raw, ksk_raw)),
                                params.TEST_PARAMS, "cpu")
    gen = torch.Generator().manual_seed(9)
    return TFHE(sk, ck, params.TEST_PARAMS, "cpu", gen, "cmux_k"), jctx


@pytest.fixture(params=KINDS)
def kind(request, pair, monkeypatch):
    """Both contexts on one adder family for the test."""
    for c in pair:
        monkeypatch.setattr(c, "circuit_adder", request.param, raising=False)
    return request.param


def enc(pair, values, width, signed=False, pool=512):
    """(port, JAX) integers of ``values`` on the same JAX encryptions, made
    as one (pool,) batch of bits so that JAX compiles its encryption once."""
    ctx, jctx = pair
    jcls, cls = (jints.FheInt, FheInt) if signed else (jints.FheUint, FheUint)
    bits = np.asarray(jcls._to_bits(values, width), np.uint32)
    flat = np.zeros(pool, np.uint32)
    flat[: bits.size] = bits.reshape(-1)
    words = np.asarray(jctx.encrypt(jnp.asarray(flat)))[: bits.size]
    words = words.reshape(bits.shape + words.shape[-1:])
    return cls(ctx, _u32.from_numpy(words, "cpu")), jcls(jctx, jnp.asarray(words))


def same(got, want):
    """Word-for-word equality of a port result and a JAX result (integers,
    ciphertext tensors, or tuples of them)."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
        return
    if isinstance(got, FheUint):
        assert type(got).__name__ == type(want).__name__
        got, want = got.bits, want.bits
    assert got.dtype == torch.int32
    assert np.array_equal(_u32.to_numpy(got), np.asarray(want))


@contextlib.contextmanager
def unchanged(*operands):
    """Assert that the block leaves every operand's bits as they were."""
    tensors = [o.bits if isinstance(o, FheUint) else o for o in operands]
    before = [t.clone() for t in tensors]
    yield
    for t, b in zip(tensors, before):
        assert torch.equal(t, b), "an op wrote into its operand"


def both(fn, *pairs_of_operands):
    """Run ``fn`` on the port operands and on the JAX operands; check the
    results equal word for word and the port operands unchanged.  Returns
    the port result."""
    ports = [p for p, _ in pairs_of_operands]
    jaxes = [j for _, j in pairs_of_operands]
    with unchanged(*ports):
        got = fn(*ports)
    same(got, fn(*jaxes))
    return got


def dec(ctx, ct):
    return ctx.decrypt(ct).numpy().astype(np.uint64)


def test_round_trip_uint(pair):
    ctx, _ = pair
    x, _ = enc(pair, A_VALS, W)
    assert x.width == W and x.batch_shape == (len(A_VALS),)
    np.testing.assert_array_equal(x.decrypt(), A_VALS)
    own = ctx.encrypt_uint(A_VALS, W)  # the port's own encryption: decrypt-correct
    assert own.bits.shape == x.bits.shape and own.bits.dtype == torch.int32
    np.testing.assert_array_equal(own.decrypt(), A_VALS)
    np.testing.assert_array_equal(ctx.trivial_uint(A_VALS, W).decrypt(), A_VALS)


def test_round_trip_sint(pair):
    ctx, _ = pair
    vals = np.array([-8, -1, 0, 3, 7, -5], np.int64)
    x, jx = enc(pair, vals, W, signed=True)
    np.testing.assert_array_equal(x.decrypt(), vals)
    np.testing.assert_array_equal(x.decrypt(), jx.decrypt())
    np.testing.assert_array_equal(ctx.encrypt_sint(vals, W).decrypt(), vals)
    np.testing.assert_array_equal(ctx.trivial_sint(vals, W).decrypt(), vals)
    assert np.array_equal(FheInt._to_bits(vals, W), np.asarray(jints.FheInt._to_bits(vals, W)))


def test_linear_ops_no_bootstrap(pair, monkeypatch):
    ctx, _ = pair
    x = enc(pair, A_VALS, W)
    monkeypatch.setattr(ctx, "bootstrap_raw", None)  # any bootstrap would fail
    np.testing.assert_array_equal(both(lambda v: ~v, x).decrypt(), (~A_VALS) & MASK)
    np.testing.assert_array_equal(both(lambda v: v << 2, x).decrypt(), (A_VALS << 2) & MASK)
    np.testing.assert_array_equal(both(lambda v: v >> 1, x).decrypt(), A_VALS >> 1)
    np.testing.assert_array_equal(both(lambda v: v >> W, x).decrypt(), A_VALS * 0)
    np.testing.assert_array_equal(both(lambda v: v << W, x).decrypt(), A_VALS * 0)
    assert both(lambda v: v << 0, x) is x[0] and both(lambda v: v.extend(W), x) is x[0]


def test_arithmetic_shift_sint(pair):
    vals = np.array([-8, -3, 5, -1], np.int64)
    x = enc(pair, vals, W, signed=True)
    np.testing.assert_array_equal(both(lambda v: v >> 1, x).decrypt(), vals >> 1)
    np.testing.assert_array_equal(both(lambda v: v >> W, x).decrypt(), vals >> 63)
    np.testing.assert_array_equal(both(lambda v: v >> (W + 3), x).decrypt(), vals >> 63)


def test_add_sub(pair, kind):
    ctx, _ = pair
    a, b = enc(pair, A_VALS, W), enc(pair, B_VALS, W)
    s, carry = both(lambda x, y: x.add_with_carry(y), a, b)
    np.testing.assert_array_equal(s.decrypt(), (A_VALS + B_VALS) & MASK)
    np.testing.assert_array_equal(dec(ctx, carry), (A_VALS + B_VALS) >> W)
    d, borrow = both(lambda x, y: x.sub_with_borrow(y), a, b)
    np.testing.assert_array_equal(d.decrypt(), (A_VALS - B_VALS) & MASK)
    np.testing.assert_array_equal(dec(ctx, borrow), A_VALS < B_VALS)
    np.testing.assert_array_equal(both(lambda x: -x, a).decrypt(), (-A_VALS) & MASK)
    # + and - are the first outputs of the same cells (the port is deterministic)
    with unchanged(a[0], b[0]):
        assert torch.equal((a[0] + b[0]).bits, s.bits) and torch.equal((a[0] - b[0]).bits, d.bits)


def test_plaintext_mixing(pair):
    a = enc(pair, A_VALS, W)
    plus3 = both(lambda x: x + 3, a)
    np.testing.assert_array_equal(plus3.decrypt(), (A_VALS + 3) & MASK)
    assert torch.equal((3 + a[0]).bits, plus3.bits)
    np.testing.assert_array_equal(both(lambda x: 10 - x, a).decrypt(), (10 - A_VALS) & MASK)
    np.testing.assert_array_equal(both(lambda x: x ^ 5, a).decrypt(), A_VALS ^ 5)


def test_mul(pair, kind):
    a, b = enc(pair, A_VALS, W), enc(pair, B_VALS, W)
    full = both(lambda x, y: x.mul_full(y), a, b)
    assert full.width == 2 * W
    np.testing.assert_array_equal(full.decrypt(), A_VALS * B_VALS)
    with unchanged(a[0], b[0]):  # the product mod 2^w: the same cell's low half
        low = a[0] * b[0]
    assert low.width == W and torch.equal(low.bits, full.bits[..., :W, :])


def test_bitwise(pair):
    a, b = enc(pair, A_VALS, W), enc(pair, B_VALS, W)
    np.testing.assert_array_equal(both(lambda x, y: x & y, a, b).decrypt(), A_VALS & B_VALS)
    np.testing.assert_array_equal(both(lambda x, y: x | y, a, b).decrypt(), A_VALS | B_VALS)
    np.testing.assert_array_equal(both(lambda x, y: x ^ y, a, b).decrypt(), A_VALS ^ B_VALS)


def test_compare_and_select(pair, kind):
    ctx, _ = pair
    a, b = enc(pair, A_VALS, W), enc(pair, B_VALS, W)
    lt, eq, gt = both(lambda x, y: x._compare(y), a, b)
    for got, want in ((lt, A_VALS < B_VALS), (eq, A_VALS == B_VALS), (gt, A_VALS > B_VALS)):
        np.testing.assert_array_equal(dec(ctx, got), want)
    # lt/eq/gt/ge/le/ne are the compare's outputs or their free negations.
    for op, want in (("lt", lt), ("eq", eq), ("gt", gt), ("ge", -lt), ("le", -gt), ("ne", -eq)):
        with unchanged(a[0], b[0]):
            assert torch.equal(getattr(a[0], op)(b[0]), want), op
    np.testing.assert_array_equal(both(lambda x, y: x.min_(y), a, b).decrypt(),
                                  np.minimum(A_VALS, B_VALS))
    np.testing.assert_array_equal(both(lambda x, y: x.max_(y), a, b).decrypt(),
                                  np.maximum(A_VALS, B_VALS))
    cond = (a[0].lt(b[0]), a[1].lt(b[1]))
    sel = both(lambda x, y, c: x.select(c, y), a, b, cond)
    np.testing.assert_array_equal(sel.decrypt(), np.where(A_VALS < B_VALS, A_VALS, B_VALS))


def test_signed_compare_abs(pair):
    ctx, _ = pair
    av = np.array([-8, -1, 0, 3, -5, 7], np.int64)
    bv = np.array([7, -1, -8, -3, -5, -7], np.int64)
    a, b = enc(pair, av, W, signed=True), enc(pair, bv, W, signed=True)
    np.testing.assert_array_equal(dec(ctx, both(lambda x, y: x.lt(y), a, b)), av < bv)
    np.testing.assert_array_equal(dec(ctx, both(lambda x, y: x.eq(y), a, b)), av == bv)
    np.testing.assert_array_equal(dec(ctx, both(lambda x, y: x.gt(y), a, b)), av > bv)
    np.testing.assert_array_equal(both(lambda x, y: x.min_(y), a, b).decrypt(), np.minimum(av, bv))
    # abs(-8) wraps to -8 at width 4 (two's complement), like wrapping_abs.
    expect = np.abs(av)
    expect[av == -(1 << (W - 1))] = -(1 << (W - 1))
    np.testing.assert_array_equal(both(lambda x: x.abs_(), a).decrypt(), expect)
    u = enc(pair, A_VALS, W)
    assert both(lambda x: x.abs_(), u) is u[0]


def test_width_extension(pair):
    a = enc(pair, np.array([9, 3], np.uint64), W)
    b = enc(pair, np.array([200, 11], np.uint64), 8)
    np.testing.assert_array_equal(both(lambda x, y: x + y, a, b).decrypt(), [209, 14])
    s = enc(pair, np.array([-3, 5], np.int64), W, signed=True)
    t = enc(pair, np.array([-100, 100], np.int64), 8, signed=True)
    np.testing.assert_array_equal(both(lambda x, y: x + y, s, t).decrypt(), [-103, 105])
    np.testing.assert_array_equal(both(lambda x: x.extend(8), s).decrypt(), [-3, 5])
    with pytest.raises(ValueError):
        t[0].extend(W)


def test_divmod(pair, kind):
    av = np.array([13, 7, 15, 0, 9, 6], np.uint64)
    bv = np.array([3, 7, 4, 5, 0, 15], np.uint64)
    a, b = enc(pair, av, W), enc(pair, bv, W)
    q, r = both(lambda x, y: x.divmod(y), a, b)
    # division by zero: q = 2^w - 1, r = a (the TFHE-library convention)
    safe = np.where(bv == 0, 1, bv)
    np.testing.assert_array_equal(q.decrypt(), np.where(bv == 0, MASK, av // safe))
    np.testing.assert_array_equal(r.decrypt(), np.where(bv == 0, av, av % safe))
    assert torch.equal((a[0] // b[0]).bits, q.bits) and torch.equal((a[0] % b[0]).bits, r.bits)


def test_multidim_batch(pair):
    vals = np.arange(6, dtype=np.uint64).reshape(2, 3)
    x, y = enc(pair, vals, W), enc(pair, vals[::-1].copy(), W)
    got = both(lambda u, v: u + v, x, y)
    assert got.batch_shape == (2, 3)
    np.testing.assert_array_equal(got.decrypt(), (vals + vals[::-1]) & MASK)


def test_rotations(pair):
    x = enc(pair, A_VALS, W)
    rotl = lambda v, k: ((v << np.uint64(k)) | (v >> np.uint64(W - k))) & MASK  # noqa: E731
    np.testing.assert_array_equal(both(lambda v: v.rotl(1), x).decrypt(), rotl(A_VALS, 1))
    np.testing.assert_array_equal(both(lambda v: v.rotr(3), x).decrypt(), rotl(A_VALS, 1))
    np.testing.assert_array_equal(both(lambda v: v.rotl(0), x).decrypt(), A_VALS)
    np.testing.assert_array_equal(both(lambda v: v.rotl(W + 2), x).decrypt(), rotl(A_VALS, 2))


def test_signed_mul_full(pair):
    """FheInt.mul_full sign-extends: the full 2w-bit product of signed
    values is the signed product.  Against JAX at width 2 (a 4-bit Wallace
    cell, within the JAX side's level width), then the JAX test's width-4
    values against numpy."""
    av = np.array([-1, -2, 1, -2, 0, 1], np.int64)
    bv = np.array([-2, -2, -1, 1, 1, 1], np.int64)
    a, b = enc(pair, av, 2, signed=True), enc(pair, bv, 2, signed=True)
    full = both(lambda x, y: x.mul_full(y), a, b)
    assert full.width == 4 and isinstance(full, FheInt)
    np.testing.assert_array_equal(full.decrypt(), av * bv)
    np.testing.assert_array_equal(both(lambda x, y: x * y, a, b).decrypt(), ((av * bv + 2) % 4) - 2)
    av = np.array([-1, -8, 3, -5, 7, 0], np.int64)
    bv = np.array([2, -8, -3, 5, 7, -6], np.int64)
    a, b = enc(pair, av, W, signed=True)[0], enc(pair, bv, W, signed=True)[0]
    with unchanged(a, b):
        full = a.mul_full(b)
    assert full.width == 2 * W
    np.testing.assert_array_equal(full.decrypt(), av * bv)


def test_operand_type_errors(pair):
    """Named methods raise TypeError on unsupported operand types; dunder
    operators defer through NotImplemented; FheUint/FheInt never mix."""
    ctx, _ = pair
    a = ctx.encrypt_uint(A_VALS, W)
    s = ctx.encrypt_sint(np.zeros(len(A_VALS), np.int64), W)
    with pytest.raises(TypeError):
        a.lt(1.5)
    with pytest.raises(TypeError):
        a.min_("nope")
    with pytest.raises(TypeError):
        a + 1.5
    with pytest.raises(TypeError):
        a + s
    with pytest.raises(TypeError):
        FheUint.divmod(s, s)  # the unsigned divider refuses signed operands
    with pytest.raises(ValueError):
        FheUint(ctx, a.bits.to(torch.int64))
    with pytest.raises(ValueError):
        ctx.encrypt_uint(A_VALS, 65)


def test_wide_plaintext_coercion(pair):
    """Plaintext operands with bits above 32 coerce exactly."""
    wide = 40
    big = (1 << 39) | (1 << 35) | 5
    x = enc(pair, np.array([0, (1 << 40) - 1], np.uint64), wide)
    np.testing.assert_array_equal(both(lambda v: v ^ big, x).decrypt(),
                                  np.array([big, ((1 << 40) - 1) ^ big], np.uint64))


def test_width64_sint_round_trip(pair):
    vals = np.array([-1, -(1 << 63), (1 << 63) - 1, 42], np.int64)
    x, jx = enc(pair, vals, 64, signed=True)
    np.testing.assert_array_equal(x.decrypt(), vals)
    np.testing.assert_array_equal(x.decrypt(), jx.decrypt())


def test_signed_divmod(pair):
    """Truncated signed division (C/Rust): q toward zero, r follows a;
    division by zero: q = 1 for a < 0 and -1 otherwise, r = a."""
    av = np.array([7, -7, 7, -7, -8, 5], np.int64)
    bv = np.array([2, 2, -2, -2, 3, 0], np.int64)
    a, b = enc(pair, av, W, signed=True), enc(pair, bv, W, signed=True)
    q, r = both(lambda x, y: x.divmod(y), a, b)
    safe = np.where(bv == 0, 1, bv)
    eq = np.fix(av / safe).astype(np.int64)
    er = av - eq * safe
    np.testing.assert_array_equal(q.decrypt(), np.where(bv == 0, np.where(av < 0, 1, -1), eq))
    np.testing.assert_array_equal(r.decrypt(), np.where(bv == 0, av, er))
