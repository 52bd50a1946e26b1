"""Fused REPL evaluation: one bootstrap batch per expression level.

Counterpart of ``rustfhe_tpu/apps/replprog.py``.  An expression (``nander``
AST) lowers on the host (numpy) to a level plan over a fixed-size wire
file: gather indices, gate coefficient triples and leaf encodings.  Five
programs then run it, as plain torch functions on the context's device:

* ``_first_level``: build the wire file from the leaf encodings, then one
  level (gather operands + linear pre-combination + one batched bootstrap
  + scatter back);
* ``_level``: one interior level on a wire file (updated in place);
* ``_final``: the root gate, stopping at the lv1 sample extraction (no key
  switch: the result is decrypted, not fed to another gate) and decrypting
  under the lv1 key;
* ``_single_gate``: ``_first_level``'s wire file plus ``_final``, for a
  depth-1 expression;
* ``_decrypt_many``: the K root wires of a pipelined line, decrypted.

A depth-d expression is d bootstrap batches; with a latency-mode key each
is one launch of the single-launch rotation K3.  Wire-file and lane
capacities are fixed per evaluator; wider expressions take the generic
evaluator path in ``nander``.

Reference anchor: ``nander/src/main.rs:56-63`` (parse/eval/decrypt loop);
the lowering mirrors ``apps/circuits.lower_folded``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tlwe
from .._u32 import from_numpy, s32
from ..bootstrap import bootstrap, gate_bootstrapping_tlwe2tlwe
from ..keys import CloudKey
from . import nander
from .circuits import Circuit, lower_folded, optimize

LEAF_ONE = 0x20000000   # trivial encoding of 1: +1/8
LEAF_ZERO = 0xE0000000  # trivial encoding of 0: -1/8


def _count_leaves(e) -> int:
    match e:
        case nander.Leaf():
            return 1
        case nander.Not(lhs=l):
            return _count_leaves(l)
        case nander.Nand(lhs=l, rhs=r) | nander.And(lhs=l, rhs=r) | \
                nander.Or(lhs=l, rhs=r) | nander.Xor(lhs=l, rhs=r):
            return _count_leaves(l) + _count_leaves(r)
    raise TypeError(f"not an expression: {e!r}")


def exprs_to_circuit(exprs) -> tuple[Circuit, list[int]]:
    """nander ASTs -> (ONE Circuit with an input wire per DISTINCT leaf
    value and one output per expression, leaf bit values).  A shared
    circuit is what lets K pipelined expressions run as one fused session
    (FusedEvaluator.eval_bits).

    Leaves are deduplicated BY VALUE: two ``1`` literals are the same
    deterministic trivial encoding (FusedEvaluator.init_wires), so they
    may share one input wire — which in turn lets the optimizer pass
    (circuits.optimize) merge identical subexpressions ACROSS the K
    pipelined expressions into one bootstrap lane."""
    n_leaves = sum(_count_leaves(e) for e in exprs)
    n_in = min(max(n_leaves, 1), 2)  # <= 2 distinct leaf values exist
    c = Circuit(n_inputs=n_in)
    leaves: list[int] = []
    leaf_wire: dict[int, int] = {}

    def walk(e) -> int:
        match e:
            case nander.Leaf(value=v):
                b = int(bool(v))
                if b not in leaf_wire:
                    leaf_wire[b] = len(leaves)
                    leaves.append(b)
                return leaf_wire[b]
            case nander.Not(lhs=l):
                return c.not_(walk(l))
            case nander.Nand(lhs=l, rhs=r):
                return c.nand(walk(l), walk(r))
            case nander.And(lhs=l, rhs=r):
                return c.and_(walk(l), walk(r))
            case nander.Or(lhs=l, rhs=r):
                return c.or_(walk(l), walk(r))
            case nander.Xor(lhs=l, rhs=r):
                return c.xor(walk(l), walk(r))
        raise TypeError(f"not an expression: {e!r}")

    c.outputs = [walk(e) for e in exprs]
    # Pad so len(leaves) == n_inputs (evaluate_plain indexes every input
    # wire; a pad wire feeds no gate, so its value is irrelevant).
    leaves += [0] * (n_in - len(leaves))
    return c, leaves


def expr_to_circuit(expr) -> tuple[Circuit, list[int]]:
    """nander AST -> (Circuit with one input wire per DISTINCT leaf value
    — at most two, see exprs_to_circuit — and the leaf bit values, padded
    to n_inputs)."""
    return exprs_to_circuit([expr])


class FusedEvaluator:
    """Fused expression evaluator over a TFHE context: a depth-d expression
    is d batched bootstraps.

    ``width``: gate lanes per level (padded; lanes beyond the level's gates
    bootstrap a zero pre-combination into a trash wire).
    ``max_wires``: wire-file size.  ``fits(expr)`` reports whether an
    expression's plan fits these capacities."""

    def __init__(self, ctx, width: int = 8, max_wires: int = 64):
        self.ctx = ctx
        self.width = width
        self.max_wires = max_wires

    # --------------------------- programs ---------------------------- #
    # Each takes the host plan arrays (numpy) and moves them to the device.
    def _words(self, a) -> torch.Tensor:
        return from_numpy(a, self.ctx.device)

    def _index(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.ctx.device)

    def _init_wires(self, leaves, nonce) -> torch.Tensor:
        """leaves (MW,) in {0, 1, 2}: 0/1 = trivial leaf bit, 2 = unused
        wire.  The nonce (n,) lands in the trash wire's mask: result-neutral
        (the trash wire feeds nothing)."""
        p, mw = self.ctx.params, self.max_wires
        lv = self._index(leaves)
        body = torch.where(lv == 1, s32(LEAF_ONE), torch.where(lv == 0, s32(LEAF_ZERO), 0))
        wires = torch.zeros((mw, p.n + 1), dtype=torch.int32, device=self.ctx.device)
        wires[:, 0] = body.to(torch.int32)
        wires[mw - 1, 1:] = self._words(nonce)
        return wires

    def _precombine(self, xa, xb, coeffs) -> torch.Tensor:
        """coeffs (..., 3) int32: ca*xa + cb*xb, plus cm*mu on the body."""
        pre = xa * coeffs[..., 0, None] + xb * coeffs[..., 1, None]
        pre[..., 0] += coeffs[..., 2] * self.ctx.params.mu
        return pre

    def _level(self, bk, ksk, wires, ia, ib, iout, coeffs) -> torch.Tensor:
        """One level, written into ``wires`` in place: ia/ib/iout (W,)
        wire indices, coeffs (W, 3) uint32."""
        pre = self._precombine(wires[self._index(ia)], wires[self._index(ib)],
                               self._words(coeffs))
        wires[self._index(iout)] = bootstrap(pre, CloudKey(bk=bk, ksk=ksk), self.ctx.params)
        return wires

    def _final(self, bk, sk1, wires, iab, coeff) -> torch.Tensor:
        """The root gate: iab (2,) wire indices, coeff (3,) uint32 -> the
        decrypted bit (0-d)."""
        iab = self._index(iab)
        pre = self._precombine(wires[iab[0]], wires[iab[1]], self._words(coeff))
        lv1 = gate_bootstrapping_tlwe2tlwe(pre, bk, self.ctx.params)
        return tlwe.decrypt_binary(lv1, sk1)

    def _first_level(self, bk, ksk, leaves, nonce, ia, ib, iout, coeffs) -> torch.Tensor:
        return self._level(bk, ksk, self._init_wires(leaves, nonce), ia, ib, iout, coeffs)

    def _single_gate(self, bk, sk1, leaves, nonce, iab, coeff) -> torch.Tensor:
        return self._final(bk, sk1, self._init_wires(leaves, nonce), iab, coeff)

    def _decrypt_many(self, sk0, wires, roots) -> torch.Tensor:
        """roots (W,) wire indices -> (W,) decrypted bits (pad lanes index
        the trash wire; their bits are dropped on the host)."""
        return tlwe.decrypt_binary(wires[self._index(roots)], sk0)

    # ----------------------------- plans ----------------------------- #
    def _plan(self, expr):
        """Lower to per-level host-side plan arrays; None if it doesn't fit."""
        circ, leaf_bits = expr_to_circuit(expr)
        if not circ.gates:  # leaf-only expression: no device work at all
            return ("const", leaf_bits[circ.outputs[0]] if leaf_bits else 0)
        circ = optimize(circ)  # exact CSE+DCE: fewer lanes per level
        coeff, in_a, in_b, out_w, n_wires, out_src, out_neg = lower_folded(circ)
        root, root_neg = int(out_src[0]), bool(out_neg[0])
        if len(out_w) == 0:  # NOT chain over a leaf: still no device work
            return ("const", leaf_bits[root] ^ root_neg)
        # +1 trash wire for pad lanes.
        if n_wires + 1 > self.max_wires:
            return None
        level_of = {}
        for w in range(circ.n_inputs):
            level_of[w] = 0
        levels: dict[int, list[int]] = {}
        for g in range(len(out_w)):
            lv = 1 + max(level_of.get(in_a[g], 0), level_of.get(in_b[g], 0))
            level_of[out_w[g]] = lv
            levels.setdefault(lv, []).append(g)
        depth = max(levels)
        plans = []
        for lv in range(1, depth):
            gsel = levels[lv]
            if len(gsel) > self.width:
                return None
            pad = self.width - len(gsel)
            ia = np.array([in_a[g] for g in gsel] + [0] * pad, np.int32)
            ib = np.array([in_b[g] for g in gsel] + [0] * pad, np.int32)
            io = np.array([out_w[g] for g in gsel] + [self.max_wires - 1] * pad,
                          np.int32)
            cs = np.array(
                [coeff[g] for g in gsel] + [(0, 0, 0)] * pad,
                np.int64) & 0xFFFFFFFF
            plans.append((ia, ib, io, cs.astype(np.uint32)))
        # Final level: the root gate only (same-level non-root gates feed
        # nothing — dead code an expression can't produce; NOT folding
        # keeps the root gate at the deepest level since every emitted
        # gate is its ancestor).  A negated root flips the decrypted bit
        # host-side (free).
        root_gates = [g for g in levels[depth] if out_w[g] == root]
        assert len(root_gates) == 1, root_gates
        g = root_gates[0]
        fin = (np.array([in_a[g], in_b[g]], np.int32),
               (np.array(coeff[g], np.int64)
                & 0xFFFFFFFF).astype(np.uint32))
        return ("run", leaf_bits, circ.n_inputs, plans, fin, root_neg)

    def fits(self, expr) -> bool:
        return self._plan(expr) is not None

    # ---------------- pipelined multi-expression session --------------- #
    def _plan_many(self, exprs):
        """Lower K expressions into ONE shared wire file: per-level plan
        arrays over the combined DAG plus the K root wires; None if any
        level exceeds the lane width, the wire file overflows, or K
        exceeds the readback width.  The last lowering is memoized by the
        expression objects' identities, so the fits_many + eval_bits pair
        the console issues per chunk lowers once, not twice.  The memo
        HOLDS the expression objects (identity compare via ``is``), so a
        freed AST's recycled id can never alias a stale plan."""
        key = tuple(exprs)
        cached = getattr(self, "_plan_memo", None)
        if (cached is not None and len(cached[0]) == len(key)
                and all(a is b for a, b in zip(cached[0], key))):
            return cached[1]
        plan = self._plan_many_uncached(exprs)
        self._plan_memo = (key, plan)
        return plan

    def _plan_many_uncached(self, exprs):
        if len(exprs) > self.width:
            return None
        circ, leaf_bits = exprs_to_circuit(exprs)
        if not circ.gates:  # all leaf-only: no device work at all
            return ("const", [leaf_bits[r] for r in circ.outputs])
        circ = optimize(circ)  # merges shared subexpressions ACROSS the K
        coeff, in_a, in_b, out_w, n_wires, out_src, out_neg = lower_folded(circ)
        if len(out_w) == 0:  # every expression folded to a (±) leaf
            return ("const",
                    [leaf_bits[int(w)] ^ bool(n)
                     for w, n in zip(out_src, out_neg)])
        if n_wires + 1 > self.max_wires:
            return None
        level_of = {w: 0 for w in range(circ.n_inputs)}
        levels: dict[int, list[int]] = {}
        for g in range(len(out_w)):
            lv = 1 + max(level_of.get(in_a[g], 0), level_of.get(in_b[g], 0))
            level_of[out_w[g]] = lv
            levels.setdefault(lv, []).append(g)
        plans = []
        for lv in range(1, max(levels) + 1):  # ALL levels run interior
            gsel = levels.get(lv, [])
            if len(gsel) > self.width:
                return None
            pad = self.width - len(gsel)
            ia = np.array([in_a[g] for g in gsel] + [0] * pad, np.int32)
            ib = np.array([in_b[g] for g in gsel] + [0] * pad, np.int32)
            io = np.array(
                [out_w[g] for g in gsel] + [self.max_wires - 1] * pad,
                np.int32)
            cs = np.array(
                [coeff[g] for g in gsel] + [(0, 0, 0)] * pad,
                np.int64) & 0xFFFFFFFF
            plans.append((ia, ib, io, cs.astype(np.uint32)))
        # Roots may resolve to leaf wires (leaf-only expressions in the
        # mix) and may carry a free NOT: the decrypted bit flips host-side.
        return ("runK", leaf_bits, plans, out_src, out_neg)

    def fits_many(self, exprs) -> bool:
        return self._plan_many(exprs) is not None

    def _leaves_nonce(self, leaf_bits, _nonce):
        leaves = np.full(self.max_wires, 2, np.uint32)
        leaves[: len(leaf_bits)] = np.asarray(leaf_bits, np.uint32)
        nonce = (np.zeros(self.ctx.params.n, np.uint32) if _nonce is None
                 else np.asarray(_nonce, np.uint32))
        return leaves, nonce

    def eval_bits(self, exprs, _nonce=None) -> list[int]:
        """Pipelined session: K expressions -> K bits with depth(combined
        DAG) bootstrap batches and one readback."""
        plan = self._plan_many(exprs)
        if plan is None:
            raise ValueError("expression batch exceeds the fused "
                             "evaluator's static capacities")
        if plan[0] == "const":
            return [int(b) for b in plan[1]]
        _, leaf_bits, plans, roots, roots_neg = plan
        leaves, nonce = self._leaves_nonce(leaf_bits, _nonce)
        ck = self.ctx.ck
        ia, ib, io, cs = plans[0]
        wires = self._first_level(ck.bk, ck.ksk, leaves, nonce, ia, ib, io, cs)
        for ia, ib, io, cs in plans[1:]:
            wires = self._level(ck.bk, ck.ksk, wires, ia, ib, io, cs)
        rootv = np.full(self.width, self.max_wires - 1, np.int32)
        rootv[: len(roots)] = np.asarray(roots, np.int32)
        arr = self._decrypt_many(self.ctx.sk.lv0, wires, rootv).cpu().numpy()
        return [int(arr[i]) ^ bool(roots_neg[i]) for i in range(len(roots))]

    def eval_bit(self, expr, _nonce=None) -> int:
        """Evaluate to a decrypted bit: depth bootstrap batches in all.

        ``_nonce``: optional uint32 (n,) written into the trash wire's mask
        — result-neutral (the trash wire feeds nothing)."""
        plan = self._plan(expr)
        if plan is None:
            raise ValueError("expression exceeds the fused evaluator's "
                             "static capacities")
        if plan[0] == "const":
            return int(plan[1])
        _, leaf_bits, n_inputs, plans, (iab, coeff), root_neg = plan
        leaves, nonce = self._leaves_nonce(leaf_bits, _nonce)
        ck = self.ctx.ck
        if not plans:  # depth-1: one bootstrap batch
            bit = self._single_gate(ck.bk, self.ctx.sk.lv1, leaves, nonce, iab, coeff)
            return int(bit) ^ root_neg
        ia, ib, io, cs = plans[0]
        wires = self._first_level(ck.bk, ck.ksk, leaves, nonce, ia, ib, io, cs)
        for ia, ib, io, cs in plans[1:]:
            wires = self._level(ck.bk, ck.ksk, wires, ia, ib, io, cs)
        bit = self._final(ck.bk, self.ctx.sk.lv1, wires, iab, coeff)
        return int(bit) ^ root_neg
