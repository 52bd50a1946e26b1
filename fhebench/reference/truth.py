"""Cleartext answers: what each request's outputs must decrypt to.

Gate truth tables (the six gates of ``rustfhe_tpu_torch/bench.py``'s
``TRUTH`` and its MUX combinations, frozen here), integer operators on
unsigned words, and logic expressions as trees of tuples
``("leaf", b)``, ``("not", e)``, ``(op, l, r)`` with op one of
``& | ^ $`` (``$`` is NAND).
"""

from __future__ import annotations

import numpy as np

GATES = {
    "nand": lambda x, y, z: 1 - (x & y),
    "and": lambda x, y, z: x & y,
    "or": lambda x, y, z: x | y,
    "xor": lambda x, y, z: x ^ y,
    "not": lambda x, y, z: 1 - x,
    "mux": lambda c, in0, in1: np.where(c == 1, in1, in0),  # (control, in0, in1)
}


def gate(op: str, x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    return GATES[op](x, y, z).astype(np.int64)


def uint_op(op: str, a: np.ndarray, b: np.ndarray, c: np.ndarray, width: int) -> np.ndarray:
    """Unsigned ``width``-bit operators: add and sub wrap; lt and eq give
    bits; min; select is ``c ? a : b``."""
    m = (1 << width) - 1
    a, b = a.astype(np.int64), b.astype(np.int64)
    if op == "add":
        return (a + b) & m
    if op == "sub":
        return (a - b) & m
    if op == "lt":
        return (a < b).astype(np.int64)
    if op == "eq":
        return (a == b).astype(np.int64)
    if op == "min":
        return np.minimum(a, b)
    if op == "select":
        return np.where(c != 0, a, b)
    raise ValueError(f"unknown operator {op!r}")


def expr(e) -> int:
    """The value of an expression tree."""
    if e[0] == "leaf":
        return int(e[1])
    if e[0] == "not":
        return 1 - expr(e[1])
    x, y = expr(e[1]), expr(e[2])
    return {"&": x & y, "|": x | y, "^": x ^ y, "$": 1 - (x & y)}[e[0]]
