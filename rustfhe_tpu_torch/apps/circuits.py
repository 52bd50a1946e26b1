"""Boolean circuits over encrypted bits: the circuit IR and its passes.

Counterpart of ``rustfhe_tpu/apps/circuits.py`` (``Gate``, ``Circuit``,
``optimize``, ``evaluate_plain``, ``lower``, ``lower_folded``).  These are
plain Python and numpy; the interactive console's fused evaluator
(``replprog``) lowers expressions through them.  The level-fused encrypted
evaluator and the standard cells are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Every primitive gate's pre-combination is linear in (x, y, mu):
# pre = ca*x + cb*y + cm*mu (mod 2^32), followed by the same bootstrap.
from ..gates import PRE_COEFFS as _COEFFS


@dataclass
class Gate:
    op: str  # nand|and|or|xor|not|mux
    inputs: tuple[int, ...]
    output: int


@dataclass
class Circuit:
    """Wire-indexed gate list.  Wires [0, n_inputs) are primary inputs."""

    n_inputs: int
    gates: list[Gate] = field(default_factory=list)
    outputs: list[int] = field(default_factory=list)
    _next: int = None  # type: ignore

    def __post_init__(self):
        if self._next is None:
            self._next = self.n_inputs

    def _new_wire(self) -> int:
        w = self._next
        self._next += 1
        return w

    def add(self, op: str, *inputs: int) -> int:
        out = self._new_wire()
        self.gates.append(Gate(op, tuple(inputs), out))
        return out

    def nand(self, a, b):
        return self.add("nand", a, b)

    def and_(self, a, b):
        return self.add("and", a, b)

    def or_(self, a, b):
        return self.add("or", a, b)

    def xor(self, a, b):
        return self.add("xor", a, b)

    def not_(self, a):
        return self.add("not", a)

    def mux(self, control, in0, in1):
        return self.add("mux", control, in0, in1)

    @property
    def n_wires(self) -> int:
        return self._next

    def levelize(self) -> list[list[Gate]]:
        """Topological layers: a gate's level = 1 + max(level of inputs)."""
        level = {w: 0 for w in range(self.n_inputs)}
        layers: dict[int, list[Gate]] = {}
        for g in self.gates:
            lv = 1 + max((level.get(w, 0) for w in g.inputs), default=0)
            level[g.output] = lv
            layers.setdefault(lv, []).append(g)
        return [layers[k] for k in sorted(layers)]

    @property
    def depth(self) -> int:
        return len(self.levelize())


_COMMUTATIVE = {"and", "or", "xor", "nand"}


def optimize(circuit: Circuit) -> Circuit:
    """Exact gate-count reduction: common-subexpression elimination +
    dead-gate elimination.

    Every gate costs one bootstrap LANE per batch element (the fused
    evaluator of ``replprog``), so duplicate or unused
    gates are pure wasted bootstrap work.  Two passes, both
    semantics-preserving bit-for-bit:

    * CSE — value numbering over the gate DAG: a gate whose
      (op, canonical inputs) was already computed reuses the earlier
      output wire; commutative 2-input ops (and/or/xor/nand) canonicalize
      their operand order first.
    * DCE — a backward reachability sweep from ``outputs`` drops gates
      whose result feeds nothing.

    Wire numbering is compacted; input wires [0, n_inputs) and the
    output LIST are preserved (an output may map to an input wire).
    Depth never increases (CSE merges into the EARLIER gate; DCE only
    removes).  The pass is idempotent and O(gates).

    The reference evaluates one gate at a time with no circuit layer at
    all (``nander/src/lib.rs:72-89``); this optimizer is part of the
    beyond-reference circuit compiler (levelizer + optimizer + fused
    batched evaluation).
    """
    rep: dict[int, int] = {w: w for w in range(circuit.n_inputs)}
    seen: dict[tuple, int] = {}
    kept: list[Gate] = []  # gates with canonicalized input wires
    for g in circuit.gates:
        ins = tuple(rep[w] for w in g.inputs)
        if g.op in _COMMUTATIVE:
            ins = tuple(sorted(ins))
        key = (g.op, ins)
        if key in seen:
            rep[g.output] = seen[key]
        else:
            seen[key] = rep[g.output] = g.output
            kept.append(Gate(g.op, ins, g.output))
    # DCE: backward sweep (kept is topologically ordered).
    needed = {rep[o] for o in circuit.outputs}
    live: list[Gate] = []
    for g in reversed(kept):
        if g.output in needed:
            live.append(g)
            needed.update(g.inputs)
    live.reverse()
    # Compact wire ids: inputs keep theirs, live gate outputs renumber.
    new_id = {w: w for w in range(circuit.n_inputs)}
    out = Circuit(n_inputs=circuit.n_inputs)
    for g in live:
        new_id[g.output] = out.add(g.op, *(new_id[w] for w in g.inputs))
    out.outputs = [new_id[rep[o]] for o in circuit.outputs]
    return out


def evaluate_plain(circuit: Circuit, inputs: np.ndarray) -> np.ndarray:
    """Plaintext evaluation; inputs (..., n_inputs) -> (..., n_outputs)."""
    inputs = np.asarray(inputs)
    wires = {w: inputs[..., w] for w in range(circuit.n_inputs)}
    for g in circuit.gates:
        a = [wires[w] for w in g.inputs]
        if g.op == "nand":
            wires[g.output] = 1 - (a[0] & a[1])
        elif g.op == "and":
            wires[g.output] = a[0] & a[1]
        elif g.op == "or":
            wires[g.output] = a[0] | a[1]
        elif g.op == "xor":
            wires[g.output] = a[0] ^ a[1]
        elif g.op == "not":
            wires[g.output] = 1 - a[0]
        elif g.op == "mux":
            wires[g.output] = np.where(a[0] != 0, a[2], a[1])
        else:
            raise ValueError(g.op)
    return np.stack([wires[w] for w in circuit.outputs], axis=-1)


def lower(circuit: Circuit):
    """Lower to linear-precombination primitives: mux(c, in0, in1) becomes
    and(c, in1), andn(c, in0), or(.., ..) (the reference's 3-bootstrap
    decomposition, tfhe.rs:29-39).  Returns (ops, in_a, in_b, out, n_wires)
    as numpy arrays over primitive gate indices."""
    ops, in_a, in_b, outs = [], [], [], []
    next_wire = circuit.n_wires
    for g in circuit.gates:
        if g.op == "mux":
            c, i0, i1 = g.inputs
            w1, w2 = next_wire, next_wire + 1
            next_wire += 2
            ops += ["and", "andn", "or"]
            in_a += [c, c, w1]
            in_b += [i1, i0, w2]
            outs += [w1, w2, g.output]
        elif g.op == "not":
            ops.append("not")
            in_a.append(g.inputs[0])
            in_b.append(g.inputs[0])  # unused (cb = 0)
            outs.append(g.output)
        else:
            ops.append(g.op)
            in_a.append(g.inputs[0])
            in_b.append(g.inputs[1])
            outs.append(g.output)
    return (
        np.array(ops),
        np.array(in_a, np.int64),
        np.array(in_b, np.int64),
        np.array(outs, np.int64),
        next_wire,
    )


def lower_folded(circuit: Circuit):
    """``lower`` + NOT elimination.

    NOT is FREE in TFHE: the binary encoding is ±mu, so enc(!b) is exactly
    ``tlwe.neg(enc(b))`` — an elementwise wrapping negation, no bootstrap
    (the reference's gate-level ``hom_not`` still bootstraps for API
    parity with ``tfhe.rs:66-71``; inside a CIRCUIT the refresh is
    pointless, because every consumer's pre-combination is linear).  A
    ``not`` gate therefore costs neither a bootstrap lane nor a level:

      * each consumer flips the sign of the corresponding coefficient
        (``ca*(-x) = (-ca)*x`` mod 2^32) — noise magnitude is unchanged,
        so gate margins are identical;
      * NOT chains collapse (!!x = x);
      * a negated circuit OUTPUT is one elementwise negation at
        extraction (the fused evaluator flips the decrypted bit).

    mux lowers to and/andn/or as in ``lower``.  Returns
    ``(coeffs (G, 3) int64, in_a, in_b, out_w, n_wires,
    out_src (n_outputs,) int64, out_neg (n_outputs,) bool)`` over the
    EMITTED (non-NOT) gates; an all-NOT circuit emits zero gates.
    """
    src = {w: (w, False) for w in range(circuit.n_inputs)}
    coeffs, in_a, in_b, outs = [], [], [], []
    next_wire = circuit.n_wires

    def emit(op, a, b, out):
        aw, an = src.get(a, (a, False))
        bw, bn = src.get(b, (b, False))
        ca, cb, cm = _COEFFS[op]
        coeffs.append((-ca if an else ca, -cb if bn else cb, cm))
        in_a.append(aw)
        in_b.append(bw)
        outs.append(out)
        src[out] = (out, False)

    for g in circuit.gates:
        if g.op == "not":
            w, n = src.get(g.inputs[0], (g.inputs[0], False))
            src[g.output] = (w, not n)
        elif g.op == "mux":
            c, i0, i1 = g.inputs
            w1, w2 = next_wire, next_wire + 1
            next_wire += 2
            emit("and", c, i1, w1)
            emit("andn", c, i0, w2)
            emit("or", w1, w2, g.output)
        else:
            emit(g.op, g.inputs[0], g.inputs[1], g.output)

    out_src = [src.get(o, (o, False)) for o in circuit.outputs]
    return (
        np.array(coeffs, np.int64).reshape(-1, 3),
        np.array(in_a, np.int64),
        np.array(in_b, np.int64),
        np.array(outs, np.int64),
        next_wire,
        np.array([w for w, _ in out_src], np.int64),
        np.array([n for _, n in out_src], bool),
    )
