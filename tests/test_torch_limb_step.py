"""K4 (merged CMux step), K6 (c-split CMux step) and K5 (external product)
of the port's limb engine.

On the CPU the wrappers run the kernels' plain versions; these are held
word for word (tolerance zero) to the Pallas kernels of the JAX engine
``"pallas"`` in interpret mode (``PallasEngine(interpret=True, tb=8)``, as
tests/test_poly.py runs them), at small N in the fast run and at
FAST_PARAMS- and DEFAULT_PARAMS-shaped N=1024 rows in the slow tests.
K4/K6's pieces (the limb panel and the products in K4's and K6's tile
orders) are held to K1's panel and to the plain step.  The CUDA kernels
themselves are compared with their plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import poly as jpoly
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.engine.pallas_step import PallasEngine
from rustfhe_tpu.params import TFHEParams as JParams
from rustfhe_tpu_torch import _u32, params, poly
from rustfhe_tpu_torch.engine import cmux_k, limb_step, plain, probe_vectors

# (N, l, bgbit): a FAST_PARAMS-shaped and a DEFAULT_PARAMS-shaped small set.
SMALL = [(128, 2, 8), (256, 3, 6)]
FULL = [(1024, 2, 8), (1024, 3, 6)]
EDGE_WORDS = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]


def _params(N, l, bgbit):
    return params.TFHEParams(n=8, N=N, l=l, bgbit=bgbit), JParams(n=8, N=N, l=l, bgbit=bgbit)


def _words(rs, shape):
    return rs.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _rows(seed, p):
    return _words(np.random.RandomState(seed), (2 * p.l, 2, p.N))


def _digits(seed, p, B):
    """Random digits in [-half_bg, half_bg), with the probe vectors' digit
    sets (all -half_bg, all half_bg - 1, alternating) as the first rows."""
    rs = np.random.RandomState(seed)
    d = rs.randint(-p.half_bg, p.half_bg, size=(B, 2 * p.l, p.N)).astype(np.int32)
    probe = probe_vectors(p)[1]
    d[: len(probe)] = probe[:B]
    return d


def _acc(seed, p, B):
    """Random accumulators and rotations with edge words and a~ in {0, 1, N, 2N-1}."""
    rs = np.random.RandomState(seed)
    acc = _words(rs, (B, 2, p.N))
    acc[0, 0, :5] = EDGE_WORDS
    acc[1, 1, -5:] = EDGE_WORDS
    acc[2] = np.array(EDGE_WORDS, np.uint32)[np.arange(2 * p.N) % 5].reshape(2, p.N)
    ai = rs.randint(0, 2 * p.N, size=(B,)).astype(np.int32)
    ai[:4] = [0, 1, p.N, 2 * p.N - 1]
    return acc, ai


def _table(rows):
    return plain.prepare_trgsw_limbs(_u32.from_numpy(rows))


def _pallas_extprod(rows, digits, jp):
    pe = PallasEngine(interpret=True, tb=8)
    return np.asarray(pe.external_product_digits(pe.prepare_trgsw(jnp.asarray(rows), jp),
                                                 jnp.asarray(digits), jp))


def _pallas_step(rows, acc, ai, jp, merge_c):
    pe = PallasEngine(interpret=True, tb=8, merge_c=merge_c)
    return np.asarray(pe.cmux_step(pe.prepare_trgsw(jnp.asarray(rows), jp), jnp.asarray(acc),
                                   jnp.asarray(ai), jp))


def _port_extprod(rows, digits, p):
    d8 = torch.from_numpy(digits).to(torch.int8)
    return _u32.to_numpy(limb_step.external_product(d8, _table(rows), p))


def _port_step(step, rows, acc, ai, p):
    return _u32.to_numpy(step(_u32.from_numpy(acc), torch.from_numpy(ai), _table(rows), p))


# --------------------------------------------------------------------- #
# The limb table
# --------------------------------------------------------------------- #
def test_signed_limbs_of_q_and_neg_q_at_int8_edges():
    words = np.array([0x00000080, 0x0000007F, 0x80808080, 0x7F7F7F7F, 0x80000000,
                      0xFFFFFFFF, 0x00000000, 0x00000001, 0x7FFFFFFF, 0x81818181],
                     np.uint32)
    neg = (~words + np.uint32(1)).astype(np.uint32)
    for w in (words, neg):
        got = poly.to_signed_limbs(_u32.from_numpy(w), 8, 4)
        want = np.asarray(jpoly.to_signed_limbs(jnp.asarray(w), 8, 4))
        assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
        back = sum(got.numpy().astype(np.int64)[:, k] << (8 * k) for k in range(4))
        assert np.array_equal((back & 0xFFFFFFFF).astype(np.uint32), w)
    # -q is split on its own: its limbs are not the negated limbs of q
    # (a limb of -128 has no int8 negation).
    lq = poly.to_signed_limbs(_u32.from_numpy(words), 8, 4).numpy().astype(np.int32)
    lneg = poly.to_signed_limbs(_u32.from_numpy(neg), 8, 4).numpy().astype(np.int32)
    assert (lq == -128).any() and not np.array_equal(lneg, -lq)


@pytest.mark.parametrize("N,l,bgbit", SMALL)
def test_limb_table_matches_jax_prepare_trgsw(N, l, bgbit):
    p, jp = _params(N, l, bgbit)
    rows = _rows(1, p)
    rows[0, 0, :5] = EDGE_WORDS
    got = _table(rows).numpy()  # (2L, 2, K, 2N): [limbs(-q), limbs(q)]
    assert got.shape == (2 * l, 2, 4, 2 * N) and got.dtype == np.int8
    want = np.asarray(get_engine("matmul").prepare_trgsw(jnp.asarray(rows), jp))
    # JAX's MatmulEngine table is [limbs(q), limbs(-q)]: the halves swap.
    assert np.array_equal(got, np.concatenate([want[..., N:], want[..., :N]], axis=-1))
    # PallasEngine holds the same limbs c-major, (2, 2L*K, 2N).
    pall = np.asarray(PallasEngine(tb=8).prepare_trgsw(jnp.asarray(rows), jp))
    assert np.array_equal(np.moveaxis(want, 1, 0).reshape(2, 2 * l * 4, 2 * N), pall)


# --------------------------------------------------------------------- #
# K5, K4 and K6 plain against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("N,l,bgbit", SMALL)
def test_external_product_matches_pallas_interpret(N, l, bgbit, B):
    p, jp = _params(N, l, bgbit)
    rows, digits = _rows(2, p), _digits(3, p, B)
    before = limb_step.external_product.launches
    got = _port_extprod(rows, digits, p)
    assert limb_step.external_product.launches == before  # the plain version launches nothing
    assert np.array_equal(got, _pallas_extprod(rows, digits, jp))


@pytest.mark.parametrize("merge_c", [True, False])
@pytest.mark.parametrize("N,l,bgbit", SMALL)
def test_cmux_step_matches_pallas_interpret(N, l, bgbit, merge_c):
    p, jp = _params(N, l, bgbit)
    rows = _rows(4, p)
    acc, ai = _acc(5, p, 16)
    step = limb_step.cmux_step_merged if merge_c else limb_step.cmux_step_split
    before = (limb_step.cmux_step_merged.launches, limb_step.cmux_step_split.launches)
    got = _port_step(step, rows, acc, ai, p)
    assert (limb_step.cmux_step_merged.launches, limb_step.cmux_step_split.launches) == before
    assert np.array_equal(got, _pallas_step(rows, acc, ai, jp, merge_c))


@pytest.mark.slow
@pytest.mark.parametrize("N,l,bgbit", FULL)
def test_kernels_match_pallas_interpret_at_n1024(N, l, bgbit):
    p, jp = _params(N, l, bgbit)
    rows, digits = _rows(6, p), _digits(7, p, 8)
    assert np.array_equal(_port_extprod(rows, digits, p), _pallas_extprod(rows, digits, jp))
    acc, ai = _acc(8, p, 8)
    for merge_c, step in ((True, limb_step.cmux_step_merged),
                          (False, limb_step.cmux_step_split)):
        assert np.array_equal(_port_step(step, rows, acc, ai, p),
                              _pallas_step(rows, acc, ai, jp, merge_c))


# --------------------------------------------------------------------- #
# The two engines compute the same function
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["FAST_PARAMS", "DEFAULT_PARAMS"])
def test_limb_step_equals_cmux_k_step(name):
    p = getattr(params, name)
    rows = _rows(9, p)
    acc, ai = _acc(10, p, 4)
    t_acc, t_ai = _u32.from_numpy(acc), torch.from_numpy(ai)
    want = cmux_k.cmux_step(t_acc, t_ai, plain.prepare_trgsw(_u32.from_numpy(rows)), p)
    assert torch.equal(limb_step.cmux_step_merged(t_acc, t_ai, _table(rows), p), want)
    digits = torch.from_numpy(_digits(11, p, 4)).to(torch.int8)
    assert torch.equal(limb_step.external_product(digits, _table(rows), p),
                       cmux_k.external_product(digits, plain.prepare_trgsw(_u32.from_numpy(rows)), p))


# --------------------------------------------------------------------- #
# K4/K6's pieces: the limb panel, the products in the two tile orders
# --------------------------------------------------------------------- #
PIECE_PARAMS = {"TEST_PARAMS": params.TEST_PARAMS, "FAST_PARAMS": params.FAST_PARAMS,
                "DEFAULT_PARAMS": params.DEFAULT_PARAMS, "PBS_PARAMS": params.PBS_PARAMS}


@pytest.mark.parametrize("name", list(PIECE_PARAMS))
def test_limb_panel_equals_k1_key_panel(name):
    # the panel cut from the limb table's bytes = K1's panel split from the
    # int32 key, word for word (N=64 padded, FAST, DEFAULT, N=2048 at l=4)
    p = PIECE_PARAMS[name]
    rows = _rows(15, p)
    rows[0, 0], rows[1, 1, :5] = 0x80808080, EDGE_WORDS
    t_rows = _u32.from_numpy(rows)
    got = limb_step.limb_panel(plain.prepare_trgsw_limbs(t_rows), p)  # CPU: the plain version
    assert got.shape == cmux_k.panel_shape(p) and got.dtype == torch.int8
    assert torch.equal(got, cmux_k.key_panel_plain(plain.prepare_trgsw(t_rows), p))


@pytest.mark.parametrize("name", ["N16", "TEST_PARAMS", "FAST_PARAMS", "DEFAULT_PARAMS"])
def test_products_in_tile_order_equal_the_step(name):
    # plain limb panel + plain digits through K4's merged tile order (both
    # halves x 4 limbs x 32 coefficients) and through K6's (K1's) tile order
    # = the plain step, word for word; N=16 leaves most of K4's tile past N
    p = params.FAST_PARAMS.replace(N=16) if name == "N16" else PIECE_PARAMS[name]
    rows = _rows(16, p)
    acc, ai = _acc(17, p, 5)
    table, t_acc, t_ai = _table(rows), _u32.from_numpy(acc), torch.from_numpy(ai)
    want = limb_step.cmux_step_plain(t_acc, t_ai, table, p)
    digits = cmux_k.step_digits_plain(t_acc, t_ai, p)
    panel = limb_step.limb_panel_plain(table, p)
    assert torch.equal(limb_step.merged_product_plain(digits, panel, t_acc, p), want)
    assert torch.equal(cmux_k.panel_product_plain(digits, panel, t_acc, p), want)
    # the wrapper on CPU tensors: the plain version
    assert torch.equal(limb_step.merged_product(digits, panel, t_acc, p), want)


# --------------------------------------------------------------------- #
# The wrappers check their operands
# --------------------------------------------------------------------- #
def test_wrappers_check_their_operands():
    p, _ = _params(128, 2, 8)
    rows = _rows(12, p)
    acc, ai = _acc(13, p, 4)
    table, t_acc, t_ai = _table(rows), _u32.from_numpy(acc), torch.from_numpy(ai)
    d8 = torch.from_numpy(_digits(14, p, 4)).to(torch.int8)
    for step in (limb_step.cmux_step_merged, limb_step.cmux_step_split):
        with pytest.raises(TypeError):
            step(t_acc, t_ai.to(torch.int64), table, p)
        with pytest.raises(TypeError):
            step(t_acc, t_ai, table.to(torch.int32), p)
        with pytest.raises(ValueError):
            step(t_acc[:, :, :64], t_ai, table, p)
        with pytest.raises(ValueError):
            step(t_acc, t_ai, table[:2], p)
        with pytest.raises(ValueError):
            step(t_acc.transpose(0, 1).contiguous().transpose(0, 1), t_ai, table, p)
    with pytest.raises(TypeError):
        limb_step.external_product(d8.to(torch.int32), table, p)
    with pytest.raises(ValueError):
        limb_step.external_product(d8[:, :2], table, p)
    with pytest.raises(TypeError):
        plain.external_product_limbs(d8.to(torch.int32), table)
    # a tensor on another device than the first operand's
    meta = torch.empty((4, 2, p.N), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="is on cpu, expected meta"):
        limb_step.cmux_step_merged(meta, t_ai, table, p)
    # a meta tensor has neither a kernel nor a plain version
    m_ai = torch.empty((4,), dtype=torch.int32, device="meta")
    m_tab = torch.empty(tuple(table.shape), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        limb_step.cmux_step_split(meta, m_ai, m_tab, p)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        limb_step.external_product(d8.to("meta"), m_tab, p)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        limb_step.limb_panel(m_tab, p)
    # the pieces check their operands too
    with pytest.raises(TypeError):
        limb_step.limb_panel(table.to(torch.int32), p)
    digits = cmux_k.step_digits_plain(t_acc, t_ai, p)
    panel = limb_step.limb_panel_plain(table, p)
    with pytest.raises(ValueError):
        limb_step.merged_product(digits[:, :, :64].contiguous(), panel, t_acc, p)
    with pytest.raises(ValueError):
        limb_step.merged_product(digits, panel[:1], t_acc, p)


def test_exactness_bound_check_raises():
    # 2L*N*half_bg*128 = 8 * 16384 * 128 * 128 = 2^31: one past the int32 range.
    p = params.TFHEParams(n=8, N=16384, l=4, bgbit=8)
    limb_step.check_bound(p.replace(N=8192))
    table = torch.zeros((2 * p.l, 2, 4, 2 * p.N), dtype=torch.int8)
    acc = torch.zeros((1, 2, p.N), dtype=torch.int32)
    ai = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        limb_step.cmux_step_merged(acc, ai, table, p)
    with pytest.raises(ValueError, match="2\\^31"):
        limb_step.external_product(torch.zeros((1, 2 * p.l, p.N), dtype=torch.int8), table, p)
    assert limb_step.smem_bytes(params.FAST_PARAMS, 2) == 2 * 4 * 4 * 2048 + 8 * 4 * 1024
    assert limb_step.smem_bytes(params.DEFAULT_PARAMS, 2) == 96 * 1024 + 48 * 1024
