"""The expr mix sends the same expressions for every run seed: block k holds
the same shapes (trees, operators, NOTs), in a seed-drawn order, over
seed-drawn leaves that are distinct within an expression."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from fhebench import harness

MIX = harness.load_json(harness.ROOT / "traffic" / "expr_b1.json")
EXPR = harness.load_module(harness.ROOT / "traffic" / "expr.py")


def traffic(seed: int, mix: dict = MIX):
    """The generator's request stream without keys: the leaves' ciphertexts
    stand in as one row per pool bit."""
    t = EXPR.Traffic.__new__(EXPR.Traffic)
    t.run = types.SimpleNamespace(device=torch.device("cpu"))
    t.counts = list(range(mix["ops_min"], mix["ops_max"] + 1))
    t.block = len(t.counts)
    t.operators, t.not_share = list(mix["operators"]), float(mix["not_share"])
    t.bits = torch.zeros(mix["pool"], dtype=torch.int64)
    t.cts = torch.arange(mix["pool"])[:, None]
    run_rng = np.random.default_rng(harness.seeds(seed)[2])
    t.rng = np.random.default_rng(run_rng.integers(1 << 62))
    t.shapes = np.random.default_rng(int(mix["shape_seed"]))
    t.exprs = []
    return t


def shape(e):
    if e[0] == "leaf":
        return ("leaf",)
    return (e[0],) + tuple(shape(sub) for sub in e[1:])


@pytest.mark.parametrize("seeds", [(1, 2), (7, 2 ** 31 + 99)])
def test_every_seed_sends_the_same_expressions(seeds):
    a, b = (traffic(s) for s in seeds)
    blocks = 20
    reqs = [[t.request(i)[0] for i in range(blocks * t.block)] for t in (a, b)]
    assert reqs[0] != reqs[1]
    orders = 0
    for k in range(blocks):
        one, two = (r[k * a.block:(k + 1) * a.block] for r in reqs)
        assert sorted(map(repr, map(shape, one))) == sorted(map(repr, map(shape, two)))
        orders += [shape(e) for e in one] != [shape(e) for e in two]
        for e in one + two:
            leaves = EXPR.Traffic.leaves(e)
            assert len(set(leaves)) == len(leaves)
    assert orders > 0


def operators(e) -> int:
    if e[0] == "leaf":
        return 0
    return (e[0] != "not") + sum(operators(sub) for sub in e[1:])


def test_a_block_holds_one_expression_of_each_size():
    t = traffic(3)
    ops = sorted(operators(t.request(i)[0]) for i in range(t.block))
    assert ops == list(range(MIX["ops_min"], MIX["ops_max"] + 1))


def test_a_pool_too_small_for_distinct_leaves_is_refused(tmp_path):
    from fhebench.tests import standin

    mix = dict(standin.CELLS["expr.default.b1"][3], pool=4)
    cells = {**standin.CELLS, "expr.default.b1": standin.CELLS["expr.default.b1"][:3] + (mix,)}
    old, standin.CELLS = standin.CELLS, cells
    try:
        with pytest.raises(ValueError, match="pool"):
            standin.run(tmp_path, "expr.default.b1")
    finally:
        standin.CELLS = old


def test_the_warm_up_holds_every_level_width():
    t = traffic(11)
    warmed = set().union(*(t.level_widths(r[0]) for r in t.warm()))
    sent = set().union(*(t.level_widths(t.request(i)[0]) for i in range(200 * t.block)))
    assert sent <= warmed
