"""A K1 blind rotation from one call (``cmux_k.cmux_rotate``) on the CPU.

On the CPU the wrapper runs the loop of ``cmux_step_plain``, its plain
version; these tests hold it word for word to n calls of that step, at n
odd and even (the card's ping-pong between two accumulators ends in the
one or the other), at several batches, with one test vector for every row
and with one per row.  ``bootstrap.blind_rotate`` takes it for a standard
key, and its span says so.  The card's rotation is held to the per-step
``cmux_step`` chain by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from rustfhe_tpu_torch import _u32, bootstrap, keys, params
from rustfhe_tpu_torch.engine import cmux_k, plain, rotate_all_k
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
        {"rows": B, "tv_rows": 1, "path": "k1", "steps": n, "calls": 1}]
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

