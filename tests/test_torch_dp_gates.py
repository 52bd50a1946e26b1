"""The four-card gate server's request path on gloo worlds of four rank
processes: ``gates.gate_circuit`` over ``GateSession.bootstrap_raw``, as
the benchmark's ``gates.default.dp4`` cell runs it on four cards.

Meshes (4, 1) and (2, 2) at TEST_PARAMS on K1's plain version, all six
gates, a batch of 8 (split over ``data``) and one of 6 (which 4 does not
divide: computed whole on every rank of the (4, 1) mesh).  Every rank's
outputs equal the benchmark's plain reference (``fhebench/reference/tfhe.py``,
torch alone) word for word, and its spans are the one-card bootstrap's
(``bootstrap`` over ``extract`` and ``key_switch``) with a ``collective``
span around each collective, whose ``bytes`` are those that cross cards;
no collective runs on a group of one rank.
"""

import json

import numpy as np
import pytest
import torch

from fhebench.reference import tfhe as ref
from rustfhe_tpu_torch.gates import GATE_INPUTS
from rustfhe_tpu_torch.params import TEST_PARAMS

from torch_ranks import World

MESHES = [(4, 1), (2, 2)]
BATCHES = (8, 6)
RP = ref.Params(**{k: getattr(TEST_PARAMS, k) for k in ref.Params.__dataclass_fields__})


@pytest.fixture(scope="module")
def run():
    gen = torch.Generator().manual_seed(2 ** 33 + 22)
    keys = ref.keygen(RP, gen, "cpu")
    inputs = {"lv0": keys.s0, "lv1": keys.s1, "bk_raw": keys.bk, "ksk_raw": keys.ksk}
    inputs = {k: v.numpy().view(np.uint32) for k, v in inputs.items()}
    inputs["batches"] = np.array(BATCHES)
    want = {}
    for b in BATCHES:
        cts = [ref.encrypt(gen, keys.s0, ref.bit_words(ref.bits(gen, (b,), "cpu")),
                           RP.alpha_lv0) for _ in range(3)]
        for j, ct in enumerate(cts):
            inputs[f"in{j}_{b}"] = ct.numpy().view(np.uint32)
        for op, arity in GATE_INPUTS.items():
            want[f"{op}_{b}"] = ref.gate(op, cts[:arity], keys, RP).numpy().view(np.uint32)
    worlds = {shape: World("dp_gates", *shape, inputs) for shape in MESHES}
    return want, {shape: w.results() for shape, w in worlds.items()}


def expected_spans(op: str, b: int, data: int, model: int) -> list:
    """The spans of one gate call on one rank, in the order they close:
    per bootstrap pass (MUX: a (2, b) pass, then a (b,) one) the
    extraction, the key switch's all-reduce over ``model``, ``key_switch``,
    ``bootstrap``, and the all-gather over ``data``; a collective only on a
    group of more than one rank."""
    width = TEST_PARAMS.n + 1
    out = []
    for lanes in ((2 * b, b) if op == "mux" else (b,)):
        split = b % data == 0
        rows = lanes // data if split else lanes
        out.append(["extract", {"rows": rows, "t": 1}])
        if model > 1:
            out.append(["collective", {"op": "all_reduce", "ranks": model,
                                       "bytes": 2 * (model - 1) * rows * width * 8 // model}])
        out += [["key_switch", {"rows": rows}], ["bootstrap", {"rows": rows}]]
        if split and data > 1:
            out.append(["collective", {"op": "all_gather", "ranks": data,
                                       "bytes": (data - 1) * lanes * width * 4 // data}])
    return out


@pytest.mark.parametrize("shape", MESHES)
def test_every_rank_has_the_references_words(run, shape):
    want, res = run
    for r in res[shape]:
        for name, words in want.items():
            assert np.array_equal(r[name], words), name


@pytest.mark.parametrize("shape", MESHES)
def test_spans_and_the_bytes_that_cross_cards(run, shape):
    _, res = run
    for rank, r in enumerate(res[shape]):
        spans = json.loads(str(r["spans"]))
        for op in GATE_INPUTS:
            for b in BATCHES:
                assert spans[f"{op}_{b}"] == expected_spans(op, b, *shape), (rank, op, b)


def test_no_collective_on_a_group_of_one(run):
    """On (4, 1) the key switch's ``model`` group is one rank: no all-reduce,
    only the all-gather of each pass that 4 divides."""
    _, res = run
    for r in res[4, 1]:
        colls = [attrs for spans in json.loads(str(r["spans"])).values()
                 for name, attrs in spans if name == "collective"]
        assert colls and all(c["ranks"] == 4 and c["op"] == "all_gather" for c in colls)
        assert len(colls) == 5 + 2  # five gates and MUX's two passes, at the batch of 8
