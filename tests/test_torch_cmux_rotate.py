"""A K1 blind rotation from one call (``cmux_k.cmux_rotate``) on the CPU.

On the CPU the wrapper runs the loop of ``cmux_step_plain``, its plain
version; these tests hold it word for word to n calls of that step, at n
odd and even (the card's ping-pong between two accumulators ends in the
one or the other), at several batches, with one test vector for every row
and with one per row.  ``bootstrap.blind_rotate`` takes it for a standard
key, and its span says so.  At wide batches (``cmux_k.KARATSUBA_MIN_ROWS``,
lowered here so that a small batch reaches it) the rotation takes the
Karatsuba step, whose plain version (``cmux_step_karatsuba`` on the CPU)
gives the same words, and so does the JAX package's K1 step (its own
two-level Karatsuba step, in interpret mode); the span's ``product`` says
which step ran.  The card's rotations are held to the per-step
``cmux_step`` chain by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from rustfhe_tpu_torch import _u32, bootstrap, keys, params
from rustfhe_tpu_torch.engine import cmux_k, karatsuba, plain, rotate_all_k
from rustfhe_tpu_torch.utils import trace

P16 = params.DEFAULT_PARAMS.replace(n=16, N=256)


def _rotation(seed, B, p, per_row):
    """A blind rotation's inputs from random lv0 words: the first accumulator
    and the rotations (``bootstrap.rotation_start``) and a random prepared key."""
    rs = np.random.RandomState(seed)
    ct = _u32.from_numpy(rs.randint(0, 2**32, size=(B, p.n + 1), dtype=np.uint64))
    shape = (B, 2, p.N) if per_row else (2, p.N)
    tv = _u32.from_numpy(rs.randint(0, 2**32, size=shape, dtype=np.uint64))
    rows = rs.randint(0, 2**32, size=(p.n, 2 * p.l, 2, p.N), dtype=np.uint64)
    bk = plain.prepare_trgsw(_u32.from_numpy(rows))
    acc, a_steps = bootstrap.rotation_start(ct, tv, p)
    return ct, tv, acc, a_steps, bk


def _step_chain(acc, a_steps, bk, p):
    for i in range(p.n):
        acc = cmux_k.cmux_step_plain(acc, a_steps[i], bk[i], p)
    return acc


@pytest.mark.parametrize("per_row", [False, True], ids=["one_tv", "tv_per_row"])
@pytest.mark.parametrize("B", [1, 5, 33])
@pytest.mark.parametrize("n", [16, 17])
def test_cmux_rotate_equals_the_plain_step_chain(n, B, per_row):
    p = P16.replace(n=n)
    _, _, acc, a_steps, bk = _rotation(100 * n + B, B, p, per_row)
    first = acc.clone()
    want = _step_chain(acc, a_steps, bk, p)
    k1, rot = cmux_k.cmux_step.launches, cmux_k.cmux_rotate.launches
    got = cmux_k.cmux_rotate(acc, a_steps, bk, p)
    assert (cmux_k.cmux_step.launches, cmux_k.cmux_rotate.launches) == (k1, rot)  # CPU: plain
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(acc, first)  # the plain version leaves the first accumulator alone


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("product", ["schoolbook", "karatsuba"])
def test_rotate_on_either_product_equals_the_plain_step_chain(product, steps):
    # ``rotate`` takes n from a_steps (here fewer than params.n) and the key
    # of its product: the doubled tables or their leaf tables
    p = P16
    _, _, acc, a_steps, bk = _rotation(60 + steps, 5, p, per_row=True)
    a_steps, bk = a_steps[:steps].contiguous(), bk[:steps].contiguous()
    key = bk if product == "schoolbook" else cmux_k.leaf_table(bk, p)
    want = acc
    for i in range(steps):
        want = cmux_k.cmux_step_plain(want, a_steps[i], bk[i], p)
    counts = (cmux_k.cmux_step.launches, cmux_k.cmux_step_karatsuba.launches)
    got = cmux_k.rotate(acc, a_steps, key, p, product)
    assert counts == (cmux_k.cmux_step.launches, cmux_k.cmux_step_karatsuba.launches)
    assert torch.equal(got, want)
    other = cmux_k.leaf_table(bk, p) if product == "schoolbook" else bk
    with pytest.raises((TypeError, ValueError), match="key must"):
        cmux_k.rotate(acc, a_steps, other, p, product)  # the other product's key
    with pytest.raises(ValueError, match="unknown product 'fft'"):
        cmux_k.rotate(acc, a_steps, key, p, "fft")


def test_step_buffers_are_each_products_digits_and_panels():
    p, cpu = params.DEFAULT_PARAMS, torch.device("cpu")
    digits, panel = cmux_k.step_buffers("schoolbook", 7, p, cpu, 0)
    assert digits.shape == (7, 2 * p.l, cmux_k.geometry(p.N)[0])
    assert panel.shape == cmux_k.panel_shape(p)
    leaf_digits, leaf_panel, leaves = cmux_k.step_buffers("karatsuba", 7, p, cpu, 0)
    npad, _, rows = cmux_k.geometry(p.N // karatsuba.R)
    assert leaf_digits.shape == (7, karatsuba.T, 2 * p.l, npad)
    assert leaf_panel.shape == (karatsuba.T, 2 * p.l, 2, cmux_k.LIMBS, rows, cmux_k.SLICE)
    assert all(t.dtype == torch.int8 for t in (digits, panel, leaf_digits, leaf_panel))
    # the leaf products, words: 302 MB at 16,384 rows of DEFAULT_PARAMS
    assert leaves.shape == (7, karatsuba.T, 2, p.N // karatsuba.R) and leaves.dtype == torch.int32
    assert cmux_k.step_buffers("schoolbook", 7, p, cpu, 0)[0] is digits  # kept while it fits


@pytest.mark.parametrize("key", ["standard", "latency"])
@pytest.mark.parametrize("n", [16, 17])
def test_blind_rotate_issues_k1_in_one_call(n, key):
    # a latency key above K3's cap takes the K1 rotation too
    p = P16.replace(n=n)
    B = 5 if key == "standard" else rotate_all_k.MAX_BATCH + 1
    ct, tv, acc, a_steps, bk = _rotation(7 + n, B, p, per_row=False)
    want = _step_chain(acc, a_steps, bk, p)
    k1, rot = cmux_k.cmux_step.launches, cmux_k.cmux_rotate.launches
    trace.clear()
    trace.enable()
    try:
        got = bootstrap.blind_rotate(ct, bk if key == "standard" else keys.LatencyBK(bk), tv, p)
    finally:
        trace.enable(False)
    recs = [r for r in trace.records() if r.name == "blind_rotate"]
    trace.clear()
    assert torch.equal(got, want)
    assert [r.attrs for r in recs] == [
        {"rows": B, "tv_rows": 1, "path": "k1", "steps": n, "calls": 1, "product": "schoolbook"}]
    assert (cmux_k.cmux_step.launches, cmux_k.cmux_rotate.launches) == (k1, rot)


def test_cmux_rotate_checks_its_operands():
    p = P16
    _, _, acc, a_steps, bk = _rotation(3, 4, p, per_row=False)
    with pytest.raises(ValueError, match="a_steps must have shape"):
        cmux_k.cmux_rotate(acc, a_steps[1:], bk, p)
    with pytest.raises(ValueError, match="key must have shape"):
        cmux_k.cmux_rotate(acc, a_steps, bk[1:], p)
    with pytest.raises(TypeError, match="a_steps must be torch.int32"):
        cmux_k.cmux_rotate(acc, a_steps.to(torch.int64), bk, p)
    with pytest.raises(ValueError, match="must be contiguous"):
        cmux_k.cmux_rotate(acc, a_steps.t().contiguous().t(), bk, p)
    meta = torch.empty((4, 2, p.N), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        cmux_k.cmux_rotate(meta, a_steps.to("meta"), bk.to("meta"), p)


def test_reset_counters_resets_the_rotations():
    cmux_k.cmux_rotate.launches = 3
    cmux_k.reset_counters()
    assert cmux_k.cmux_rotate.launches == 0 and cmux_k.cmux_step.launches == 0


def _lower_threshold(monkeypatch, p, rows):
    """The Karatsuba step from ``rows`` rows at ``p`` (the measured
    thresholds are thousands of rows)."""
    monkeypatch.setitem(cmux_k.KARATSUBA_MIN_ROWS, (p.N, p.l, p.bgbit), rows)


@pytest.mark.parametrize("B", [1, 5, 33])
@pytest.mark.parametrize("N", [32, 64, 256, 1024])
def test_karatsuba_step_plain_equals_the_schoolbook_step(N, B):
    p = params.DEFAULT_PARAMS.replace(n=2, N=N)
    _, _, acc, a_steps, bk = _rotation(5 * N + B, B, p, per_row=True)
    tables = cmux_k.leaf_table(bk, p)
    for i in range(p.n):
        want = cmux_k.cmux_step_plain(acc, a_steps[i], bk[i], p)
        got = cmux_k.cmux_step_karatsuba(acc, a_steps[i], tables[i], p)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert torch.equal(got, cmux_k.cmux_step_karatsuba_plain(acc, a_steps[i], tables[i], p))
        acc = got


@pytest.mark.parametrize("N", [32, 256, 1024])
def test_leaf_combine_plain_is_the_tree_combine(N):
    """The plain version of the Karatsuba step's combine launch
    (``karatsuba.combine_leaves``, ``cmux_k.leaf_combine`` on the CPU) =
    ``tree_combine`` in the residue layout (``karatsuba.combine_parts`` of
    the leaves as one unshifted limb), from random words."""
    p = params.DEFAULT_PARAMS.replace(N=N)
    rs = np.random.RandomState(N)
    acc = _u32.from_numpy(rs.randint(0, 2**32, size=(3, 2, N), dtype=np.uint64))
    leaves = _u32.from_numpy(rs.randint(0, 2**32, size=(3, karatsuba.T, 2, N // karatsuba.R),
                                        dtype=np.uint64))
    got = cmux_k.leaf_combine(acc, leaves, p)
    want = karatsuba.combine_parts(karatsuba.scan_enter(acc), leaves.to(torch.int64)[:, :, :, None],
                                   karatsuba.Step(limbs=1))
    assert got.dtype == torch.int32 and torch.equal(got, karatsuba.scan_exit(want))
    assert torch.equal(got, karatsuba.combine_leaves(acc, leaves))


def test_leaf_combine_wraps_position_zero():
    """One word x at the last position of leaf 1 (half 1): residues 0 and 1
    take it at position 0 through Z, negated (-x, +x: r0 = Z L1 + ..., r1 =
    -Z L1 + ...), residues 2 and 3 at the last position (-x, +x)."""
    p = params.DEFAULT_PARAMS.replace(N=64)
    ns = p.N // karatsuba.R
    x = 0x9E3779B9 - 2**32
    leaves = torch.zeros((2, karatsuba.T, 2, ns), dtype=torch.int32)
    leaves[1, 1, 1, ns - 1] = x
    got = cmux_k.leaf_combine(torch.zeros((2, 2, p.N), dtype=torch.int32), leaves, p)
    want = torch.zeros((2, 2, p.N), dtype=torch.int64)
    want[1, 1, [0, 1, p.N - 2, p.N - 1]] = torch.tensor([-x, x, -x, x])
    assert torch.equal(got, _u32.wrap(want))


def test_leaf_table_is_each_steps_table_kept_with_its_key():
    p = P16.replace(n=3)
    _, _, _, _, bk = _rotation(11, 1, p, per_row=False)
    tables = cmux_k.leaf_table(bk, p)
    assert tables.shape == (3,) + karatsuba.table_shape(p) and tables.dtype == torch.int8
    for i in range(3):
        assert torch.equal(tables[i], karatsuba.prepare_table(bk[i, ..., p.N:]))
    assert cmux_k.leaf_table(bk, p) is tables  # built once
    assert cmux_k.leaf_table(bk.clone(), p) is not tables
    key_id = id(bk)
    del bk
    assert key_id not in cmux_k._leaf_tables  # dropped with its key


@pytest.mark.parametrize("per_row", [False, True], ids=["one_tv", "tv_per_row"])
@pytest.mark.parametrize("n", [16, 17])
def test_cmux_rotate_takes_the_karatsuba_step_from_the_threshold(monkeypatch, n, per_row):
    p = P16.replace(n=n)
    _lower_threshold(monkeypatch, p, 5)
    for B, product in ((4, "schoolbook"), (5, "karatsuba"), (6, "karatsuba")):
        assert cmux_k.product_for(p, B) == product
        _, _, acc, a_steps, bk = _rotation(30 * n + B, B, p, per_row)
        first = acc.clone()
        want = _step_chain(acc, a_steps, bk, p)
        counts = (cmux_k.cmux_step.launches, cmux_k.cmux_step_karatsuba.launches,
                  cmux_k.cmux_rotate.launches)
        got = cmux_k.cmux_rotate(acc, a_steps, bk, p)
        assert counts == (cmux_k.cmux_step.launches, cmux_k.cmux_step_karatsuba.launches,
                          cmux_k.cmux_rotate.launches)  # CPU: plain
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert torch.equal(acc, first)


@pytest.mark.parametrize("B", [4, 5])
def test_blind_rotate_span_names_the_product(monkeypatch, B):
    p = P16
    _lower_threshold(monkeypatch, p, 5)
    ct, tv, acc, a_steps, bk = _rotation(40 + B, B, p, per_row=False)
    want = _step_chain(acc, a_steps, bk, p)
    trace.clear()
    trace.enable()
    try:
        got = bootstrap.blind_rotate(ct, bk, tv, p)
    finally:
        trace.enable(False)
    recs = [r for r in trace.records() if r.name == "blind_rotate"]
    trace.clear()
    assert torch.equal(got, want)
    assert [r.attrs["product"] for r in recs] == ["karatsuba" if B >= 5 else "schoolbook"]


def test_product_for_follows_the_measured_thresholds():
    for p in (params.DEFAULT_PARAMS, params.PBS_PARAMS):
        least = cmux_k.KARATSUBA_MIN_ROWS[(p.N, p.l, p.bgbit)]
        assert cmux_k.karatsuba_takes(p)
        assert cmux_k.product_for(p, least - 1) == "schoolbook"
        assert cmux_k.product_for(p, least) == "karatsuba"
    # no measured threshold, or a shape the step does not take (N < 32; Bg = 2^8: tree sums
    # past int8): the schoolbook step at any batch
    for p in (params.TEST_PARAMS, params.FAST_PARAMS, params.N2048_PARAMS, P16):
        assert cmux_k.product_for(p, 1 << 20) == "schoolbook"
    assert not cmux_k.karatsuba_takes(params.FAST_PARAMS)
    assert not cmux_k.karatsuba_takes(params.DEFAULT_PARAMS.replace(N=16))
    assert cmux_k.karatsuba_takes(params.DEFAULT_PARAMS.replace(N=32))  # leaves of 8 positions
    assert cmux_k.karatsuba_takes(P16)


def test_cmux_step_karatsuba_checks_its_operands():
    p = P16.replace(n=1)
    _, _, acc, a_steps, bk = _rotation(9, 3, p, per_row=False)
    table = cmux_k.leaf_table(bk, p)[0]
    with pytest.raises(ValueError, match="table must have shape"):
        cmux_k.cmux_step_karatsuba(acc, a_steps[0], table[:1], p)
    with pytest.raises(TypeError, match="table must be torch.int8"):
        cmux_k.cmux_step_karatsuba(acc, a_steps[0], table.to(torch.int32), p)
    q = p.replace(N=16)
    small = torch.zeros((3, 2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="the Karatsuba step takes"):
        cmux_k.cmux_step_karatsuba(small, a_steps[0],
                                   torch.zeros(karatsuba.table_shape(q), dtype=torch.int8), q)


def test_karatsuba_steps_match_the_jax_k1_step(monkeypatch):
    """The Karatsuba step's plain version, and a rotation on it (the
    threshold lowered), = the JAX package's K1 step (``pallas_k``'s
    two-level Karatsuba step, in interpret mode), step by step, on the same
    words."""
    import jax.numpy as jnp

    from rustfhe_tpu.engine.pallas_k import PallasKaratsubaEngine
    from rustfhe_tpu.params import TFHEParams as JParams

    p, jp, B = params.TFHEParams(n=3, N=1024), JParams(n=3, N=1024), 5
    _lower_threshold(monkeypatch, p, B)
    rs = np.random.RandomState(57)
    rows = rs.randint(0, 2**32, size=(p.n, 2 * p.l, 2, p.N), dtype=np.uint64).astype(np.uint32)
    start = rs.randint(0, 2**32, size=(B, 2, p.N), dtype=np.uint64).astype(np.uint32)
    a_np = rs.randint(0, 2 * p.N, size=(p.n, B)).astype(np.int32)
    a_np[0, :4] = [0, 1, p.N, 2 * p.N - 1]
    bk = plain.prepare_trgsw(_u32.from_numpy(rows))
    tables = cmux_k.leaf_table(bk, p)
    a_steps = torch.from_numpy(a_np)
    k2 = PallasKaratsubaEngine(interpret=True, levels=2)
    flat = k2.scan_enter(jnp.asarray(start), jp)
    acc = _u32.from_numpy(start)
    for i in range(p.n):
        flat = k2.cmux_step(k2.prepare_trgsw(jnp.asarray(rows[i]), jp), flat,
                            jnp.asarray(a_np[i]), jp)
        acc = cmux_k.cmux_step_karatsuba_plain(acc, a_steps[i], tables[i], p)
        assert np.array_equal(_u32.to_numpy(acc), np.asarray(k2.scan_exit(flat, jp)))
    assert cmux_k.product_for(p, B) == "karatsuba"
    got = cmux_k.cmux_rotate(_u32.from_numpy(start), a_steps, bk, p)
    assert np.array_equal(_u32.to_numpy(got), np.asarray(k2.scan_exit(flat, jp)))


@pytest.mark.parametrize("B", [4, 5])
def test_cmux_rotate_sets_the_product_it_took_on_the_span(monkeypatch, B):
    p = P16.replace(n=2)
    _lower_threshold(monkeypatch, p, 5)
    _, _, acc, a_steps, bk = _rotation(70 + B, B, p, per_row=False)
    trace.clear()
    trace.enable()
    try:
        with trace.span("caller") as span:
            cmux_k.cmux_rotate(acc, a_steps, bk, p, span)
        cmux_k.cmux_rotate(acc, a_steps, bk, p)  # no span given: nothing set
    finally:
        trace.enable(False)
    recs = trace.records()
    trace.clear()
    assert [(r.name, r.attrs) for r in recs] == [
        ("caller", {"product": cmux_k.product_for(p, B)})]
    assert cmux_k.product_for(p, B) == ("karatsuba" if B >= 5 else "schoolbook")
