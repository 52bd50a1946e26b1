"""The port's level-fused circuit evaluator, its standard cells and its
levelizer, against the JAX package's.

The cells and the levelizer are plain Python and numpy in both packages
and must agree exactly: the same gate lists, the same plain evaluation,
the same levels (the JAX side's levelizer is its native C++ library where
it builds, else its numpy loop).  ``evaluate_encrypted`` is deterministic:
given the JAX package's raw keys carried across with
``keys.from_jax_keys`` and the JAX ciphertexts' uint32 words, every output
word must equal JAX's (tolerance zero).  The JAX side pads its levels to
one fixed width where the port buckets them, so that JAX compiles few
programs; padding lanes change no output word.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import context as jcontext
from rustfhe_tpu import keys as jkeys
from rustfhe_tpu import native as jnative
from rustfhe_tpu.apps import circuits as jcircuits
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.params import TEST_PARAMS as J_TEST
from rustfhe_tpu_torch import TFHE, _u32, keys, native, params
from rustfhe_tpu_torch.apps import circuits

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


WIDTHS = (1, 2, 3, 4, 5, 6, 7, 8, 16)
CELLS = {
    "ripple_carry_adder": lambda m, w: m.ripple_carry_adder(w),
    "kogge_stone_adder": lambda m, w: m.kogge_stone_adder(w),
    "kogge_stone_adder_incoming_one": lambda m, w: m.kogge_stone_adder(w, incoming_one=True),
    "ripple_borrow_subtractor": lambda m, w: m.ripple_borrow_subtractor(w),
    "comparator": lambda m, w: m.comparator(w),
    "prefix_comparator": lambda m, w: m.prefix_comparator(w),
    "wallace_multiplier": lambda m, w: m.wallace_multiplier(w),
    "array_multiplier": lambda m, w: m.array_multiplier(w),
}
JAX_FIXED_WIDTH = 16  # the widest level of every circuit below


def _widths(name):
    return [w for w in WIDTHS if w >= 2 or "multiplier" not in name]


def _parts(c):
    return [(g.op, tuple(g.inputs), g.output) for g in c.gates], list(c.outputs), c.n_inputs


def _levels_both(c, jc):
    """(port levels, depth), (JAX levels, depth) of the lowered circuit."""
    got, want = [], []
    for mod, circ, lev in ((circuits, c, native.levelize), (jcircuits, jc, jnative.levelize)):
        _, in_a, in_b, out_w, n_wires, _, _ = mod.lower_folded(mod.optimize(circ))
        inputs3 = np.stack([in_a, in_b, np.full(len(out_w), -1, np.int64)], axis=1)
        (got if mod is circuits else want).append(
            lev(len(out_w), n_wires, circ.n_inputs, inputs3, out_w))
    return got[0], want[0]


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_gate_lists_and_plain_evaluation_match_jax(name):
    rs = np.random.RandomState(len(name))
    for w in _widths(name):
        c, jc = CELLS[name](circuits, w), CELLS[name](jcircuits, w)
        assert _parts(c) == _parts(jc), (name, w)
        assert c.depth == jc.depth
        assert _parts(circuits.optimize(c)) == _parts(jcircuits.optimize(jc))
        bits = rs.randint(0, 2, size=(64, c.n_inputs))
        assert np.array_equal(circuits.evaluate_plain(c, bits), jcircuits.evaluate_plain(jc, bits))


@pytest.mark.parametrize("name", list(CELLS))
def test_levelize_matches_jax_on_every_cell(name):
    for w in _widths(name):
        (got, depth), (want, jdepth) = _levels_both(CELLS[name](circuits, w),
                                                    CELLS[name](jcircuits, w))
        assert depth == jdepth and np.array_equal(got, want), (name, w)
        assert got.dtype == np.int64


def _random_dag(mod, seed, n_in=8, n_gates=200):
    rs = np.random.RandomState(seed)
    c = mod.Circuit(n_inputs=n_in)
    wires = list(range(n_in))
    for _ in range(n_gates):
        r = rs.rand()
        if r < 0.15:
            w = c.not_(int(rs.choice(wires)))
        elif r < 0.30:
            w = c.mux(*(int(x) for x in rs.choice(wires, 3)))
        else:
            a, b = (int(x) for x in rs.choice(wires, 2))
            w = c.add(["nand", "and", "or", "xor"][rs.randint(4)], a, b)
        wires.append(w)
    c.outputs = [int(x) for x in rs.choice(wires, 12)]
    return c


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_levelize_matches_jax_on_random_dags(seed):
    (got, depth), (want, jdepth) = _levels_both(_random_dag(circuits, seed),
                                                _random_dag(jcircuits, seed))
    assert depth == jdepth > 0 and np.array_equal(got, want)
    # Raw (unlowered) gate lists with 3-input muxes, unused slots -1.
    rs = np.random.RandomState(seed)
    n_wires, n_gates = 40, 30
    inputs3 = rs.randint(-1, 8, size=(n_gates, 3))
    outputs = 8 + rs.permutation(n_wires - 8)[:n_gates]
    for g in range(1, n_gates):  # feed some earlier gate outputs forward
        inputs3[g, rs.randint(3)] = outputs[rs.randint(g)]
    got = native.levelize(n_gates, n_wires, 8, inputs3, outputs)
    want = jnative.levelize(n_gates, n_wires, 8, inputs3, outputs)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])


def test_levelize_refuses_wires_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        native.levelize(1, 4, 2, np.array([[0, 4, -1]]), np.array([3]))
    with pytest.raises(ValueError, match="out of range"):
        native.levelize(1, 4, 2, np.array([[0, 1, -1]]), np.array([4]))
    assert native.levelize(0, 4, 2, np.zeros((0, 3)), np.zeros(0))[1] == 0


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5, 9, 16, 17, 255, 256, 257, 600])
def test_bucket_matches_jax(k):
    assert circuits._bucket(k) == jcircuits._bucket(k)


# --------------------------------------------------------------------- #
# evaluate_encrypted against JAX's, word for word
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pair():
    k1, k2 = jax.random.split(jax.random.PRNGKey(33))
    jsk = jkeys.gen_secret_key(k1, J_TEST)
    bk_raw, ksk_raw = jkeys.gen_cloud_key_raw(k2, jsk, J_TEST, "matmul")
    m = get_engine("matmul")
    jck = jkeys.CloudKey(bk=m.prepare_trgsw(bk_raw, J_TEST), ksk=m.prepare_ksk(ksk_raw, J_TEST))
    jctx = jcontext.TFHE(jsk, jck, J_TEST, "matmul")
    jctx._enc_key = jax.random.PRNGKey(34)
    sk, ck = keys.from_jax_keys(*(np.asarray(x) for x in (jsk.lv0, jsk.lv1, bk_raw, ksk_raw)),
                                params.TEST_PARAMS, "cpu")
    return TFHE(sk, ck, params.TEST_PARAMS, "cpu", engine_name="cmux_k"), jctx


def jax_encrypt(jctx, bits, pool=256):
    """JAX encryptions of ``bits`` (any shape, at most ``pool`` bits), made
    as one (pool,) batch so that JAX compiles its encryption once."""
    bits = np.asarray(bits, np.uint32)
    flat = np.zeros(pool, np.uint32)
    flat[: bits.size] = bits.reshape(-1)
    cts = np.asarray(jctx.encrypt(jnp.asarray(flat)))[: bits.size]
    return jnp.asarray(cts.reshape(bits.shape + cts.shape[-1:]))


def _bits_of(v, n):
    return [(v >> i) & 1 for i in range(n)]


def _both(pair, circuit_fn, bits, fixed_width=None, jax_fixed_width=JAX_FIXED_WIDTH):
    """Encrypt ``bits`` in JAX, evaluate the circuit in both packages on the
    same words; check every output word equal.  Returns the decrypted bits."""
    ctx, jctx = pair
    jcts = jax_encrypt(jctx, bits)
    cts = _u32.from_numpy(np.asarray(jcts), "cpu")
    before = cts.clone()
    got = circuits.evaluate_encrypted(circuit_fn(circuits), ctx, cts, fixed_width=fixed_width)
    want = jcircuits.evaluate_encrypted(circuit_fn(jcircuits), jctx, jcts,
                                        fixed_width=jax_fixed_width)
    assert torch.equal(cts, before), "evaluate_encrypted wrote into its inputs"
    assert got.dtype == torch.int32 and np.array_equal(_u32.to_numpy(got), np.asarray(want))
    dec = ctx.decrypt(got).numpy()
    assert np.array_equal(dec, np.asarray(jctx.decrypt(want)))
    return dec


def test_encrypted_adder_8bit_matches_jax(pair):
    cases = [(0, 0), (1, 1), (170, 85), (255, 255), (200, 100)]
    bits = np.array([_bits_of(a, 8) + _bits_of(b, 8) for a, b in cases])
    dec = _both(pair, lambda m: m.ripple_carry_adder(8), bits)  # the cases as one batch
    assert [sum(int(dec[r, i]) << i for i in range(9)) for r in range(5)] == [a + b for a, b in cases]
    dec = _both(pair, lambda m: m.ripple_carry_adder(8), bits[3])  # unbatched
    assert sum(int(dec[i]) << i for i in range(9)) == 510


def test_encrypted_mux_gate_matches_jax(pair):
    def mux(m):
        c = m.Circuit(n_inputs=3)
        c.outputs = [c.mux(0, 1, 2)]
        return c

    for control, i0, i1 in [(0, 0, 1), (1, 0, 1), (0, 1, 0), (1, 1, 0)]:
        # Both packages bucket here: levels of 2 and 1 lanes.
        dec = _both(pair, mux, [control, i0, i1], jax_fixed_width=None)
        assert int(dec[0]) == (i1 if control else i0)


def test_encrypted_subtractor_comparator_match_jax(pair):
    cases = [(200, 100), (100, 200), (85, 85), (0, 255)]
    bits = np.array([_bits_of(a, 8) + _bits_of(b, 8) for a, b in cases])
    d = _both(pair, lambda m: m.ripple_borrow_subtractor(8), bits)
    cmp = _both(pair, lambda m: m.comparator(8), bits)
    for r, (a, b) in enumerate(cases):
        assert sum(int(d[r, i]) << i for i in range(8)) == (a - b) % 256
        assert int(d[r, 8]) == int(a < b)
        assert cmp[r].tolist() == [int(a < b), int(a == b), int(a > b)]


def test_encrypted_multiplier_3bit_matches_jax(pair):
    cases = [(7, 7), (5, 6), (3, 4), (0, 7)]
    bits = np.array([_bits_of(a, 3) + _bits_of(b, 3) for a, b in cases])  # (4, 6)
    dec = _both(pair, lambda m: m.array_multiplier(3), bits)
    assert [sum(int(dec[r, i]) << i for i in range(6)) for r in range(4)] == [a * b for a, b in cases]
    assert np.array_equal(dec, circuits.evaluate_plain(circuits.array_multiplier(3), bits))


def test_encrypted_leading_batch_axes_match_jax(pair):
    pairs = [(0, 3), (1, 1), (2, 3), (3, 3), (2, 1), (1, 0)]
    bits = np.array([_bits_of(a, 2) + _bits_of(b, 2) for a, b in pairs]).reshape(2, 3, 4)
    dec = _both(pair, lambda m: m.kogge_stone_adder(2), bits)
    assert dec.shape == (2, 3, 3)
    sums = (dec * (1 << np.arange(3))).sum(-1).reshape(-1)
    assert sums.tolist() == [a + b for a, b in pairs]


def test_encrypted_fixed_width_matches_jax(pair):
    rs = np.random.RandomState(3)
    bits = rs.randint(0, 2, size=(4, 8))
    # The port at the JAX side's width and at the widest level's (8).
    for width in (JAX_FIXED_WIDTH, 8):
        dec = _both(pair, lambda m: m.kogge_stone_adder(4), bits, fixed_width=width)
        assert np.array_equal(dec, circuits.evaluate_plain(circuits.kogge_stone_adder(4), bits))
    ctx, _ = pair
    cts = ctx.encrypt(bits)
    with pytest.raises(ValueError, match="fixed_width 4 is below a level of 8"):
        circuits.evaluate_encrypted(circuits.kogge_stone_adder(4), ctx, cts, fixed_width=4)


def test_no_gate_circuit_runs_no_bootstrap_and_matches_jax(pair, monkeypatch):
    def passthrough(m):
        c = m.Circuit(n_inputs=3)
        c.outputs = [2, c.not_(0), c.not_(c.not_(1)), 0]
        return c

    ctx, _ = pair
    calls = []
    monkeypatch.setattr(ctx, "bootstrap_raw", lambda pre: calls.append(pre) or None)
    dec = _both(pair, passthrough, [[1, 0, 1], [0, 1, 1]])
    assert not calls
    assert dec.tolist() == [[1, 0, 0, 1], [1, 1, 1, 0]]


def test_negated_output_matches_jax(pair):
    def negated(m):
        c = m.Circuit(n_inputs=4)
        x = c.xor(0, 1)
        c.outputs = [c.not_(c.and_(x, 2)), c.not_(x), c.or_(c.not_(3), x)]
        return c

    bits = np.array([[0, 0, 1, 1], [1, 0, 1, 0], [0, 1, 1, 1], [1, 1, 0, 0]])
    dec = _both(pair, negated, bits)
    assert np.array_equal(dec, circuits.evaluate_plain(negated(circuits), bits))


def test_evaluate_encrypted_refuses_inputs_it_cannot_take(pair):
    ctx, _ = pair
    adder = circuits.ripple_carry_adder(2)
    cts = ctx.encrypt(np.zeros(4, np.int64))
    with pytest.raises(ValueError, match="int32"):
        circuits.evaluate_encrypted(adder, ctx, cts.to(torch.int64))
    with pytest.raises(ValueError, match=r"\(\.\.\., 4, n\+1\)"):
        circuits.evaluate_encrypted(adder, ctx, cts[:3])
