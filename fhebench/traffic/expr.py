"""One interactive user's expressions over their encrypted bits: each
request is one logic expression whose leaves are the client's encrypted
bits, at batch 1, lowered to a circuit (``apps.circuits.Circuit``) and
evaluated level by level (``evaluate_encrypted``: one ``bootstrap_raw``
a level at its bucketed width), then handed back encrypted.

Mix parameters: ``ops_min``..``ops_max`` binary operators an expression (a
block holds one expression of each count), ``operators`` drawn uniformly
from ``& | ^ $`` (``$`` is NAND), ``not_share`` (the chance of a NOT on
each node), ``pool`` (encrypted bits the leaves are drawn from, at least
``ops_max + 1``), ``shape_seed``, ``check`` (the capture of sampled level
bootstraps).  Each expression is a random binary tree of its operators.

The shapes (tree, operators, NOTs) of block k are drawn from
``shape_seed`` alone, so every run seed sends the same expressions, and
so the same levels and widths, block by block; the run seed draws the
order within each block and the leaves, distinct within an expression so
that no seed lets the optimizer share a gate that another seed does not.
"""

from __future__ import annotations

import numpy as np
import torch

from fhebench import checks, harness
from fhebench.reference import tfhe as ref
from fhebench.reference import truth
from fhebench.traffic import _common

GATE = {"&": "and_", "|": "or_", "^": "xor", "$": "nand"}


class Traffic:
    probes = ({"target": "rustfhe_tpu_torch.context:TFHE.bootstrap_raw", "kind": "gate", "ct": 1},)

    def __init__(self, run):
        from rustfhe_tpu_torch.apps import circuits

        self.run, self.circuits = run, circuits
        mix = run.mix
        self.counts = list(range(int(mix["ops_min"]), int(mix["ops_max"]) + 1))
        self.block = len(self.counts)
        self.operators = list(mix["operators"])
        self.not_share = float(mix["not_share"])
        self.bits = ref.bits(run.gen, (int(mix["pool"]),), run.device)
        self.cts = _common.encrypt_bits(run, self.bits)
        if len(self.bits) < self.counts[-1] + 1:
            raise ValueError(f"pool {len(self.bits)} < ops_max + 1 = {self.counts[-1] + 1}")
        self.rng = np.random.default_rng(run.rng.integers(1 << 62))
        self.shapes = np.random.default_rng(int(mix["shape_seed"]))
        self.exprs: list = []

    def _shape(self, ops: int):
        """A tree of ``ops`` operators from ``shape_seed``; its leaves are
        ("leaf", None) until ``_fill`` draws them."""
        rng = self.shapes
        if ops == 0:
            node = ("leaf", None)
        else:
            left = int(rng.integers(0, ops))
            node = (self.operators[int(rng.integers(0, len(self.operators)))],
                    self._shape(left), self._shape(ops - 1 - left))
        return ("not", node) if rng.random() < self.not_share else node

    @staticmethod
    def _fill(e, pick):
        if e[0] == "leaf":
            return ("leaf", int(next(pick)))
        return (e[0],) + tuple(Traffic._fill(sub, pick) for sub in e[1:])

    @staticmethod
    def leaves(e) -> list[int]:
        if e[0] == "leaf":
            return [e[1]]
        return [i for sub in e[1:] for i in Traffic.leaves(sub)]

    def request(self, i):
        """(tree, the leaves' ciphertexts (leaves, n+1)): the client's
        side, outside the timed request."""
        while len(self.exprs) <= i:
            shapes = [self._shape(c) for c in self.counts]
            for k in self.rng.permutation(len(shapes)):
                pick = iter(self.rng.permutation(len(self.bits)))
                tree = self._fill(shapes[k], pick)
                idx = torch.as_tensor(self.leaves(tree), device=self.run.device)
                self.exprs.append((tree, self.cts[idx]))
        return self.exprs[i]

    @staticmethod
    def level_widths(e) -> set[int]:
        """The gate counts of the expression's levels, each operator one
        level above its deeper operand (NOTs fold into signs)."""
        counts: dict[int, int] = {}

        def level(e):
            if e[0] == "leaf":
                return 0
            if e[0] == "not":
                return level(e[1])
            k = 1 + max(level(e[1]), level(e[2]))
            counts[k] = counts.get(k, 0) + 1
            return k

        level(e)
        return set(counts.values())

    def warm(self):
        """The first block, and from the next 64 blocks each expression that
        brings a level width not yet warmed."""
        reqs = [self.request(i) for i in range(self.block)]
        seen = set().union(*(self.level_widths(r[0]) for r in reqs))
        for i in range(self.block, 65 * self.block):
            new = self.level_widths(self.request(i)[0]) - seen
            if new:
                reqs.append(self.request(i))
                seen |= new
        return reqs

    def send(self, req):
        tree, cts = req
        c = self.circuits.Circuit(n_inputs=cts.shape[0])
        leaf = iter(range(cts.shape[0]))

        def lower(e):
            if e[0] == "leaf":
                return next(leaf)
            if e[0] == "not":
                return c.not_(lower(e[1]))
            a = lower(e[1])
            return getattr(c, GATE[e[0]])(a, lower(e[2]))

        c.outputs = [lower(tree)]
        out = self.circuits.evaluate_encrypted(c, self.run.ctx, cts)
        harness.sync(self.run.device)
        return out

    def units(self, req) -> int:
        return 1

    @staticmethod
    def with_bits(e, bits):
        """The tree with each leaf's pool index replaced by its bit."""
        if e[0] == "leaf":
            return ("leaf", int(bits[e[1]]))
        return (e[0],) + tuple(Traffic.with_bits(sub, bits) for sub in e[1:])

    def judge(self, run):
        bits = self.bits.cpu().numpy()
        got = ref.decrypt_bits(torch.cat([r.out for r in run.records]), run.keys.s0).cpu().numpy()
        bad = [int(g) != truth.expr(self.with_bits(r.req[0], bits))
               for g, r in zip(got, run.records)]
        words, _ = checks.captured_words(run)
        return {"wrong_outputs": (sum(bad), 0), "wrong_words": (words, 0)}, sum(bad)
