"""The port's radix integers (``radix.py``) against the JAX package's, on
every case of ``tests/test_radix.py`` at PBS_TEST_PARAMS (N=256, l=4, the
CPU analogue of PBS_PARAMS).

The JAX package's raw keys are carried across (``keys.from_jax_keys``; the
port runs ``"cmux_k"``, K1's plain version on the CPU, the JAX side
``"matmul"``: both exact), and the operands are JAX encryptions carried
across as uint32 words, so every op is deterministic: the port's output
digits must equal JAX's word for word (tolerance zero), the decrypted
values must equal numpy's, and every op must leave its operands as they
were.  The JAX side pads every PBS level to one batch of ``POOL`` rows
(padding rows are independent lanes and change no output word) and every
circuit level to one width, so that it compiles few programs.
"""

import contextlib
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import context as jcontext
from rustfhe_tpu import ints as jints
from rustfhe_tpu import keys as jkeys
from rustfhe_tpu import pbs as jpbs
from rustfhe_tpu import radix as jradix
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.params import DEFAULT_PARAMS as J_DEFAULT
from rustfhe_tpu.params import PBS_TEST_PARAMS as J_PBS_TEST
from rustfhe_tpu_torch import TFHE, FheUint, _u32, keys, params, pbs, radix
from rustfhe_tpu_torch.radix import RadixInt, RadixUint

U32 = jnp.uint32
ND = 3  # digits -> 6-bit integers
MASK = (1 << (2 * ND)) - 1
POOL = 128  # the JAX side's rows per PBS level (the widest level here: 108)

A = np.array([0, 1, 13, 42, 63, 29], np.uint64)
B = np.array([0, 63, 9, 21, 1, 50], np.uint64)
AS = np.array([-32, -1, 0, 5, 31, -17], np.int64)
BS = np.array([3, -1, -32, 6, -31, 20], np.int64)


def _wrap(v):
    return ((v + 32) & 63) - 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _padded(fn, many):
    """JAX's pbs / pbs_many on the rows padded to a multiple of POOL: one
    compiled program per (space, raw, unsafe, t) instead of one per level
    shape."""

    def call(ck, ct, table, *, space, params, engine_name="matmul", raw=False, unsafe=False):
        ct, table = jnp.asarray(ct, U32), jnp.asarray(table).astype(U32)
        tail = table.shape[-2:] if many else table.shape[-1:]
        lead = jnp.broadcast_shapes(ct.shape[:-1], table.shape[: table.ndim - len(tail)])
        flat = jnp.broadcast_to(ct, lead + ct.shape[-1:]).reshape(-1, ct.shape[-1])
        tabs = jnp.broadcast_to(table, lead + tail).reshape((-1,) + tail)
        rows = flat.shape[0]
        pad = -rows % POOL
        flat = jnp.concatenate([flat, jnp.zeros((pad, flat.shape[1]), U32)])
        tabs = jnp.concatenate([tabs, jnp.zeros((pad,) + tail, U32)])
        out = fn(ck, flat, tabs, space=space, params=params, engine_name=engine_name, raw=raw,
                 unsafe=unsafe)
        return out[:rows].reshape(lead + out.shape[1:])

    return call


@pytest.fixture(scope="module")
def pair():
    """(port context, JAX context) on one key set."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(17))
    jp = J_PBS_TEST
    jsk = jkeys.gen_secret_key(k1, jp)
    bk_raw, ksk_raw = jkeys.gen_cloud_key_raw(k2, jsk, jp, "matmul")
    m = get_engine("matmul")
    jck = jkeys.CloudKey(bk=m.prepare_trgsw(bk_raw, jp), ksk=m.prepare_ksk(ksk_raw, jp))
    jctx = jcontext.TFHE(jsk, jck, jp, "matmul")
    jctx._enc_key = jax.random.PRNGKey(18)
    jctx.circuit_fixed_width = 64  # the widest level of every bit circuit here
    sk, ck = keys.from_jax_keys(*(np.asarray(x) for x in (jsk.lv0, jsk.lv1, bk_raw, ksk_raw)),
                                params.PBS_TEST_PARAMS, "cpu")
    ctx = TFHE(sk, ck, params.PBS_TEST_PARAMS, "cpu", torch.Generator().manual_seed(19),
               "cmux_k")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpbs, "pbs", _padded(jpbs.pbs, many=False))
        mp.setattr(jpbs, "pbs_many", _padded(jpbs.pbs_many, many=True))
        yield ctx, jctx


def enc(pair, values, nd=ND, signed=False, pool=256):
    """(port, JAX) radix integers of ``values`` on the same JAX encryptions
    (one pooled encryption shape, so that JAX compiles it once)."""
    ctx, jctx = pair
    jcls, cls = (jradix.RadixInt, RadixInt) if signed else (jradix.RadixUint, RadixUint)
    digs = np.asarray(jcls._to_digits(values, nd), np.uint32)
    flat = np.zeros(pool, np.uint32)
    flat[: digs.size] = digs.reshape(-1)
    words = np.asarray(jpbs.encrypt_int(jctx._next_key(), jctx.sk.lv0, jnp.asarray(flat),
                                        radix.SPACE, jctx.params))[: digs.size]
    words = words.reshape(digs.shape + words.shape[-1:])
    return cls(ctx, _u32.from_numpy(words)), jcls(jctx, jnp.asarray(words))


def enc_bits(pair, values, width, pool=256):
    """(port, JAX) FheUint of ``values`` on the same JAX encryptions."""
    ctx, jctx = pair
    bits = np.asarray(jints.FheUint._to_bits(values, width), np.uint32)
    flat = np.zeros(pool, np.uint32)
    flat[: bits.size] = bits.reshape(-1)
    words = np.asarray(jctx.encrypt(jnp.asarray(flat)))[: bits.size]
    words = words.reshape(bits.shape + words.shape[-1:])
    return FheUint(ctx, _u32.from_numpy(words)), jints.FheUint(jctx, jnp.asarray(words))


def _tensors(x):
    if isinstance(x, RadixUint):
        return [x.digits]
    if isinstance(x, FheUint):
        return [x.bits]
    if isinstance(x, torch.Tensor):
        return [x]
    return []


def same(got, want):
    """Word-for-word equality of a port result and a JAX result (radix or
    bit integers, ciphertext tensors, or tuples of them)."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
        return
    if isinstance(got, (RadixUint, FheUint)):
        assert type(got).__name__ == type(want).__name__
        got, want = _tensors(got)[0], (want.digits if isinstance(got, RadixUint) else want.bits)
    assert got.dtype == torch.int32
    assert np.array_equal(_u32.to_numpy(got), np.asarray(want))


@contextlib.contextmanager
def unchanged(*operands):
    """Assert that the block leaves every operand's tensors as they were."""
    tensors = [t for o in operands for t in _tensors(o)]
    before = [t.clone() for t in tensors]
    yield
    for t, b in zip(tensors, before):
        assert torch.equal(t, b), "an op wrote into its operand"


def both(fn, *pairs_of_operands):
    """``fn`` on the port operands (which must stay unchanged) and on the
    JAX operands; the results equal word for word.  Returns the port's."""
    ports = [p for p, _ in pairs_of_operands]
    with unchanged(*ports):
        got = fn(*ports)
    same(got, fn(*[j for _, j in pairs_of_operands]))
    return got


def bit(ctx, ct):
    return ctx.decrypt(ct).numpy().astype(np.uint64)


# ---------------------------------------------------------------------- #
def test_check_radix_contract():
    ok, msg = radix.check_radix(params.PBS_PARAMS)
    assert ok, msg
    ok_m, msg_m = radix.check_radix(params.PBS_PARAMS, use_many=True)
    assert ok_m and "7.9" in msg_m, msg_m
    ok_d, msg_d = radix.check_radix(params.DEFAULT_PARAMS)
    assert not ok_d, f"DEFAULT must be rejected for radix: {msg_d}"
    ok_t, msg_t = radix.check_radix(params.PBS_TEST_PARAMS)
    assert ok_t, msg_t
    from rustfhe_tpu import params as jparams

    for name in ("PBS_PARAMS", "DEFAULT_PARAMS", "PBS_TEST_PARAMS", "TEST_PARAMS",
                 "N2048_PARAMS", "FAST_PARAMS"):
        p, jp = getattr(params, name), getattr(jparams, name)
        for use_many in (False, True):
            assert radix.check_radix(p, use_many) == jradix.check_radix(jp, use_many)
        assert radix.check_radix_mul(p) == jradix.check_radix_mul(jp)
    for kind in ("msg", "carry"):
        assert np.array_equal(radix._digit_tables(kind), jradix._digit_tables(kind))
    assert (radix.MSG_BITS, radix.MSG_MOD, radix.SPACE) == (
        jradix.MSG_BITS, jradix.MSG_MOD, jradix.SPACE)


def test_round_trip(pair):
    ctx, jctx = pair
    x, jx = enc(pair, A)
    assert x.ndigits == ND and x.width == 2 * ND and x.batch_shape == (len(A),)
    np.testing.assert_array_equal(x.decrypt(), A)
    np.testing.assert_array_equal(x.decrypt(), jx.decrypt())
    own = RadixUint.encrypt(ctx, A, ND)  # the port's own encryption: decrypt-correct
    assert own.digits.shape == x.digits.shape and own.digits.dtype == torch.int32
    np.testing.assert_array_equal(own.decrypt(), A)
    t = RadixUint.trivial(ctx, B, ND)
    same(t, jradix.RadixUint.trivial(jctx, B, ND))  # noiseless: word for word
    np.testing.assert_array_equal(t.decrypt(), B)
    assert np.array_equal(RadixUint._to_digits(A, ND), np.asarray(jradix.RadixUint._to_digits(A, ND)))


def test_add(pair):
    ctx, _ = pair
    a, b = enc(pair, A), enc(pair, B)
    s, carry = both(lambda x, y: x.add_with_carry(y), a, b)
    np.testing.assert_array_equal(s.decrypt(), (A + B) & MASK)
    carry_dec = ctx.decrypt_int(carry, radix.SPACE).numpy()
    np.testing.assert_array_equal(carry_dec, (A + B) >> np.uint64(2 * ND))
    np.testing.assert_array_equal(both(lambda x: x + 7, a).decrypt(), (A + 7) & MASK)
    with unchanged(a[0], b[0]):
        assert torch.equal((a[0] + b[0]).digits, s.digits)


def test_add_use_many(pair):
    # The t=2 PBSmanyLUT extraction (one rotation per digit level).
    # unsafe=True: the t^2-scaled drift scores ~4.2 sigma at these test
    # dimensions (a tiny-nbit artifact).
    a, b = enc(pair, A), enc(pair, B)
    s, _ = both(lambda x, y: x.add_with_carry(y, use_many=True, unsafe=True), a, b)
    np.testing.assert_array_equal(s.decrypt(), (A + B) & MASK)


def test_sub(pair):
    ctx, _ = pair
    a, b = enc(pair, A), enc(pair, B)
    d, not_borrow = both(lambda x, y: x.sub_with_not_borrow(y), a, b)
    np.testing.assert_array_equal(d.decrypt(), (A - B) & MASK)
    nb_dec = ctx.decrypt_int(not_borrow, radix.SPACE).numpy()
    np.testing.assert_array_equal(nb_dec, (A >= B).astype(np.uint64))
    np.testing.assert_array_equal(both(lambda x: -x, a).decrypt(), (-A) & MASK)
    np.testing.assert_array_equal(both(lambda x: 63 - x, a).decrypt(), (63 - A) & MASK)


def test_compare(pair):
    ctx, _ = pair
    a, b = enc(pair, A), enc(pair, B)
    np.testing.assert_array_equal(bit(ctx, both(lambda x, y: x.lt(y), a, b)), A < B)
    np.testing.assert_array_equal(bit(ctx, both(lambda x, y: x.eq(y), a, b)), A == B)
    np.testing.assert_array_equal(bit(ctx, both(lambda x, y: x.ge(y), a, b)), A >= B)
    np.testing.assert_array_equal(bit(ctx, both(lambda x, y: x.gt(y), a, b)), A > B)


def from_bits(x, **kw):
    """The package's ``from_bits`` for the integer ``x`` (port or JAX)."""
    cls = RadixUint if isinstance(x, FheUint) else jradix.RadixUint
    return cls.from_bits(x, **kw)


def test_bit_bridges(pair):
    a, ja = enc(pair, A)
    jbits = ja.to_bits()
    with unchanged(a):
        bits = a.to_bits()
    same(bits, jbits)
    assert isinstance(bits, FheUint) and bits.width == 2 * ND
    np.testing.assert_array_equal(bits.decrypt(), A)
    back = both(from_bits, (bits, jbits))
    assert back.ndigits == ND
    np.testing.assert_array_equal(back.decrypt(), A)
    # Odd widths round up to the next digit.
    r5 = both(from_bits, enc_bits(pair, A & 31, 5))
    assert r5.ndigits == 3
    np.testing.assert_array_equal(r5.decrypt(), A & 31)


def test_guard_raises_at_default_params():
    ctx = TFHE(None, None, params.DEFAULT_PARAMS, "cpu")
    a = RadixUint(ctx, np.zeros((1, 2, params.DEFAULT_PARAMS.n + 1), np.uint32))
    with pytest.raises(ValueError, match="margin below threshold") as exc:
        a.add_with_carry(a)
    jctx = jcontext.TFHE(None, None, J_DEFAULT, "matmul")
    ja = jradix.RadixUint(jctx, np.zeros((1, 2, J_DEFAULT.n + 1), np.uint32))
    with pytest.raises(ValueError) as jexc:
        ja.add_with_carry(ja)
    assert str(exc.value) == str(jexc.value)


@pytest.mark.slow
def test_mul(pair):
    ok, msg = radix.check_radix_mul(params.PBS_PARAMS)
    assert ok, msg  # the PBS preset supports the multiply at 5.5 sigma
    a, b = enc(pair, A), enc(pair, B)
    np.testing.assert_array_equal(both(lambda x, y: x * y, a, b).decrypt(), (A * B) & MASK)
    full = both(lambda x, y: x.mul(y, full=True), a, b)
    assert full.ndigits == 2 * ND
    np.testing.assert_array_equal(full.decrypt(), A * B)
    np.testing.assert_array_equal(both(lambda x: x * 3, a).decrypt(), (A * 3) & MASK)


def test_chained_ops(pair):
    # Outputs are fresh bootstrap outputs: ops compose without refresh.
    a, b = enc(pair, A), enc(pair, B)
    c = both(lambda x, y: (x + y) - y, a, b)
    np.testing.assert_array_equal(c.decrypt(), A)


@pytest.mark.slow
def test_signed_radix(pair):
    ctx, _ = pair
    a, b = enc(pair, AS, signed=True), enc(pair, BS, signed=True)
    np.testing.assert_array_equal(a[0].decrypt(), AS)
    np.testing.assert_array_equal(both(lambda x, y: x + y, a, b).decrypt(), _wrap(AS + BS))
    np.testing.assert_array_equal(both(lambda x, y: x - y, a, b).decrypt(), _wrap(AS - BS))
    np.testing.assert_array_equal(both(lambda x, y: x * y, a, b).decrypt(), _wrap(AS * BS))
    np.testing.assert_array_equal(both(lambda x: x + (-5), a).decrypt(), _wrap(AS - 5))
    np.testing.assert_array_equal(bit(ctx, both(lambda x, y: x.lt(y), a, b)), AS < BS)
    np.testing.assert_array_equal(bit(ctx, both(lambda x, y: x.ge(y), a, b)), AS >= BS)
    np.testing.assert_array_equal(both(lambda x, y: x.max_(y), a, b).decrypt(),
                                  np.maximum(_wrap(AS), _wrap(BS)))
    np.testing.assert_array_equal(both(lambda x: x.abs_(), a).decrypt(), _wrap(np.abs(AS)))


def test_signed_radix_guards(pair):
    ctx, _ = pair
    a = RadixInt.encrypt(ctx, AS[:1], ND)
    u = RadixUint.encrypt(ctx, np.array([1], np.uint64), ND)
    with pytest.raises(TypeError, match="cannot mix"):
        a + u
    with pytest.raises(TypeError, match="operand must be"):
        u + 1.5
    with pytest.raises(ValueError, match="digit-count mismatch"):
        u + RadixUint.encrypt(ctx, np.array([1], np.uint64), ND + 1)


def test_unsigned_select_min_max(pair):
    a, b = enc(pair, A), enc(pair, B)
    np.testing.assert_array_equal(both(lambda x, y: x.min_(y), a, b).decrypt(), np.minimum(A, B))
    np.testing.assert_array_equal(both(lambda x, y: x.max_(y), a, b).decrypt(), np.maximum(A, B))


def test_adaptive_from_pbs_int(pair):
    # At PBS_TEST_PARAMS t=2/t=4 fail the calibrated check and t=1 passes:
    # the bridge splits into per-bit rotations without an unsafe override.
    ctx, jctx = pair
    assert not pbs.check_pbs_many(params.PBS_TEST_PARAMS, 8, 2)[0]
    assert pbs.check_pbs_space(params.PBS_TEST_PARAMS, 8)[0]
    xs = np.array([0, 3, 5, 7, 4, 1], np.uint32)
    flat = np.zeros(256, np.uint32)
    flat[: xs.size] = xs
    jct = jctx.encrypt_int(jnp.asarray(flat), 8)[: xs.size]
    ct = _u32.from_numpy(np.asarray(jct))
    with unchanged(ct):
        u = ctx.int_to_uint(ct, 8)
    assert u.width == 3
    same(u, jctx.int_to_uint(jct, 8))
    np.testing.assert_array_equal(u.decrypt(), xs)
    np.testing.assert_array_equal((u + 1).decrypt(), (xs + 1) & 7)
    own = ctx.encrypt_int(xs, 8)  # the port's own encryption
    np.testing.assert_array_equal(ctx.int_to_uint(own, 8).decrypt(), xs)


@pytest.mark.slow
def test_bridge_backed_divmod_bitwise(pair):
    av = np.array([13, 7, 63, 0, 9], np.uint64)
    bv = np.array([3, 7, 4, 5, 0], np.uint64)
    a, b = enc(pair, av), enc(pair, bv)
    q, r = both(lambda x, y: x.divmod(y), a, b)
    eq = np.where(bv == 0, MASK, av // np.where(bv == 0, 1, bv))
    er = np.where(bv == 0, av, av % np.where(bv == 0, 1, bv))
    np.testing.assert_array_equal(q.decrypt(), eq)
    np.testing.assert_array_equal(r.decrypt(), er)
    np.testing.assert_array_equal(both(lambda x, y: x & y, a, b).decrypt(), av & bv)
    np.testing.assert_array_equal(both(lambda x, y: x ^ y, a, b).decrypt(), av ^ bv)
    np.testing.assert_array_equal(both(lambda x: x | 5, a).decrypt(), av | 5)


@pytest.mark.slow
def test_signed_radix_divmod(pair):
    av = np.array([7, -7, 7, -7, -31], np.int64)
    bv = np.array([2, 2, -2, -2, 3], np.int64)
    a, b = enc(pair, av, signed=True), enc(pair, bv, signed=True)
    q, r = both(lambda x, y: x.divmod(y), a, b)
    eq = np.fix(av / bv).astype(np.int64)
    np.testing.assert_array_equal(q.decrypt(), eq)
    np.testing.assert_array_equal(r.decrypt(), av - eq * bv)


# ----------------------------- shifts and flags ----------------------------- #
def test_shift_left(pair):
    x = enc(pair, A)
    for k in (0, 1, 2, 3, 4, 2 * ND):
        got = both(lambda v: v.shift_left(k), x).decrypt()
        np.testing.assert_array_equal(got, (A << np.uint64(k)) & MASK, err_msg=f"k={k}")
    assert x[0].shift_left(0) is x[0]


def test_shift_right(pair):
    x = enc(pair, A)
    for k in (0, 1, 2, 3, 5, 2 * ND):
        got = both(lambda v: v.shift_right(k), x).decrypt()
        np.testing.assert_array_equal(got, (A & MASK) >> np.uint64(k), err_msg=f"k={k}")
    with pytest.raises(ValueError):
        x[0].shift_right(-1)


def test_shift_operators_and_signed_pattern(pair):
    x = enc(pair, A)
    np.testing.assert_array_equal(both(lambda v: v << 3, x).decrypt(), (A << np.uint64(3)) & MASK)
    np.testing.assert_array_equal(both(lambda v: v >> 2, x).decrypt(), A >> np.uint64(2))
    sv = np.array([-3, 5, -32, 31], np.int64)
    s = enc(pair, sv, signed=True)
    want = (sv << 1).astype(np.int64)
    want = ((want + (1 << (2 * ND - 1))) & MASK) - (1 << (2 * ND - 1))
    got = both(lambda v: v << 1, s)
    assert isinstance(got, RadixInt)
    np.testing.assert_array_equal(got.decrypt(), want)


def test_add_overflows(pair):
    ctx, _ = pair
    x, y = enc(pair, A), enc(pair, B)
    s, ovf = both(lambda u, v: u.add_overflows(v), x, y)
    np.testing.assert_array_equal(s.decrypt(), (A + B) & MASK)
    np.testing.assert_array_equal(bit(ctx, ovf), ((A + B) >> np.uint64(2 * ND)) & 1)


def test_signed_add_with_overflow(pair):
    ctx, _ = pair
    lo, hi = -(1 << (2 * ND - 1)), 1 << (2 * ND - 1)
    av = np.array([31, -32, 20, -20, 1, -1], np.int64)
    bv = np.array([1, -1, 20, -20, -1, 1], np.int64)
    x, y = enc(pair, av, signed=True), enc(pair, bv, signed=True)
    s, ovf = both(lambda u, v: u.add_with_overflow(v), x, y)
    true_sum = av + bv
    want_ovf = ((true_sum < lo) | (true_sum >= hi)).astype(np.uint64)
    np.testing.assert_array_equal(s.decrypt(), ((true_sum + hi) & MASK) - hi)
    np.testing.assert_array_equal(bit(ctx, ovf), want_ovf)


def test_scalar_mul_fast_path(pair):
    x = enc(pair, A)
    for c in (0, 1, 2, 3, 10, 63):
        got = both(lambda v: v * c, x).decrypt()
        np.testing.assert_array_equal(got, (A * np.uint64(c)) & MASK, err_msg=f"c={c}")


def test_scalar_mul_full_width(pair):
    vals = np.array([13, 63, 42], np.uint64)
    x = enc(pair, vals)
    got = both(lambda v: v.mul(21, full=True), x)
    np.testing.assert_array_equal(got.decrypt(), vals * np.uint64(21))


def test_signed_full_width_mul(pair):
    av = np.array([-3, 5, -32, 31], np.int64)
    bv = np.array([7, -6, 2, -31], np.int64)
    x, y = enc(pair, av, signed=True), enc(pair, bv, signed=True)
    got = both(lambda u, v: u.mul(v, full=True), x, y)
    assert isinstance(got, RadixInt) and got.ndigits == 2 * ND
    np.testing.assert_array_equal(got.decrypt(), av * bv)


def test_comparisons_and_bridges_gated_at_default():
    """The margin gate reaches comparisons and bit bridges (space-8
    lookups), raising at DEFAULT_PARAMS before any key is touched, with the
    JAX message; every public method takes unsafe=True."""
    ctx = TFHE(None, None, params.DEFAULT_PARAMS, "cpu")
    a = RadixUint(ctx, np.zeros((1, 2, params.DEFAULT_PARAMS.n + 1), np.uint32))
    jctx = jcontext.TFHE(None, None, J_DEFAULT, "matmul")
    ja = jradix.RadixUint(jctx, np.zeros((1, 2, J_DEFAULT.n + 1), np.uint32))
    for op in (lambda v: v.lt(v), lambda v: v.eq(v), lambda v: v.to_bits()):
        with pytest.raises(ValueError, match="lower-bound margin") as exc:
            op(a)
        with pytest.raises(ValueError) as jexc:
            op(ja)
        assert str(exc.value) == str(jexc.value)
    for name in ("lt", "eq", "le", "gt", "ge", "ne", "to_bits", "select",
                 "min_", "max_", "divmod", "add_overflows"):
        sig = inspect.signature(getattr(RadixUint, name))
        assert "unsafe" in sig.parameters, name
        assert list(sig.parameters) == list(
            inspect.signature(getattr(jradix.RadixUint, name)).parameters), name


# ------------------------------ the port's own ------------------------------ #
def test_context_radix_constructors_and_seeded(pair):
    ctx, _ = pair
    np.testing.assert_array_equal(ctx.encrypt_radix(A, ND).decrypt(), A)
    np.testing.assert_array_equal(ctx.trivial_radix(B, ND).decrypt(), B)
    s = ctx.encrypt_radix_signed(AS, ND)
    assert isinstance(s, RadixInt)
    np.testing.assert_array_equal(s.decrypt(), AS)
    cloud = ctx.cloud_only()
    with pytest.raises(ValueError, match="cloud-only"):
        cloud.encrypt_radix(A, ND)
    with pytest.raises(ValueError, match="cloud-only"):
        RadixUint(cloud, s.digits).decrypt()
    for fn in (lambda: RadixUint.encrypt_seeded(ctx, A, ND),
               lambda: RadixUint.expand_seeded(ctx, None)):
        with pytest.raises(NotImplementedError, match="item G"):
            fn()
    with pytest.raises(ValueError):
        RadixUint(ctx, torch.zeros(3, dtype=torch.int32))


def test_radix_bench_on_the_cpu(monkeypatch, capsys):
    """The port of examples/radix_bench.py runs its sections and
    assertions end to end on the CPU, at PBS_TEST_PARAMS in place of
    PBS_PARAMS (its numbers mean nothing there)."""
    from rustfhe_tpu_torch.examples import radix_bench

    monkeypatch.setattr(radix_bench, "PBS_PARAMS", params.PBS_TEST_PARAMS)
    for k, v in {"RUSTFHE_FORCE_CPU": "1", "BATCH": "4", "PBS_BATCH": "16", "KEYFILE": ""}.items():
        monkeypatch.setenv(k, v)
    radix_bench.main()
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK"), out
    for section in ("pbs space=8 B=16: 16/16 correct", "radix add8 B=4: 4/4 correct",
                    "bit-circuit add8 B=4: 4/4 correct", "radix mul8 B=4: 4/4 correct",
                    "pbs_many(8,2) B=4", "radix shl2", "radix shl3", "radix shr3",
                    "radix scalar x10", "radix add_overflows", "radix SIGNED full-width"):
        assert section in out, section
    assert os.environ.get("KEYFILE") == ""
