"""The frozen yardstick gives the hand-worked values."""

from __future__ import annotations

import pytest

from fhebench.metrics import _roofline
from fhebench.reference.tfhe import Params

DEFAULT = Params(635, 1024, 2.0 ** -15, 2.0 ** -25, 6, 3, 2, 8)
PBS = Params(714, 2048, 2.0 ** -17, 2.0 ** -32, 6, 4, 4, 4)


def test_step_ops_by_hand():
    # 2 x (2 halves x 4 limbs x 2L x 9 leaves x (N/4)^2) a sample and step
    assert _roofline.step_ops(DEFAULT, 1) == 2 * 2 * 4 * 6 * 9 * 256 ** 2 == 56_623_104
    assert _roofline.step_ops(PBS, 1) == 2 * 2 * 4 * 8 * 9 * 512 ** 2 == 301_989_888
    assert _roofline.step_ops(DEFAULT, 3, 2) == 6 * 56_623_104


def test_rotation_at_default_is_bound_by_operations():
    # 16,384 rows x 635 steps x 56,623,104 ops = 5.891e14 ops -> 0.2977 s
    ops = 16384 * 635 * 56_623_104
    assert ops == pytest.approx(5.8911e14, rel=1e-4)
    assert _roofline.rotation_least_s(DEFAULT, 16384, 1) == pytest.approx(ops / 1979e12)
    assert _roofline.rotation_least_s(DEFAULT, 16384, 1) == pytest.approx(0.29768, rel=1e-4)


def test_rotation_at_batch_one_by_hand():
    # DEFAULT, 1 row: 635 x 56,623,104 = 3.5956e10 ops -> 18.17 us; bytes:
    # key 635*6*2*1024 + acc 2*2*1024 + input 636 + testvec 2*1024 words
    words = 635 * 6 * 2 * 1024 + 2 * 2 * 1024 + 636 + 2 * 1024
    assert _roofline.rotation_bytes(DEFAULT, 1, 1) == 4 * words
    t, by = _roofline.bound(635 * 56_623_104, 4 * words)
    assert by == "operations" and t == pytest.approx(18.169e-6, rel=1e-3)
    # PBS, 512 rows with a table each: 512 x 714 x 301,989,888 = 1.104e14 ops
    assert _roofline.rotation_least_s(PBS, 512, 512) == pytest.approx(
        512 * 714 * 301_989_888 / 1979e12)


def test_bound_picks_the_larger():
    assert _roofline.bound(1979e12, 3.35e12) == (1.0, "operations")
    assert _roofline.bound(1979e12, 6.7e12) == (2.0, "bytes")
