"""The circuit levelizer, host-side numpy.

Counterpart of ``rustfhe_tpu/native.py::levelize``.  The JAX package calls
its C++ levelizer through ctypes (``native/libnegacyclic.so``) and keeps a
numpy loop beside it for hosts without a toolchain; the port carries the
numpy loop alone and loads no library.  Both give the same levels: a
gate's level is one more than the highest level of its input wires
(primary inputs are level 0), counted in gate order.
"""

from __future__ import annotations

import numpy as np


def levelize(n_gates: int, n_wires: int, n_inputs: int,
             inputs3: np.ndarray, outputs: np.ndarray) -> tuple[np.ndarray, int]:
    """Levels of ``n_gates`` gates in topological order: returns (levels
    (n_gates,) int64, 1-based; depth).

    ``inputs3`` (n_gates, 3) holds each gate's input wires, -1 for an
    unused slot; ``outputs`` (n_gates,) its output wire.  A wire id outside
    [0, n_wires) raises, as the JAX package's native levelizer refuses it.
    ``n_inputs`` is accepted for the JAX signature and not needed.
    """
    del n_inputs
    ins = np.ascontiguousarray(inputs3, np.int64).reshape(n_gates, 3)
    outs = np.ascontiguousarray(outputs, np.int64).reshape(n_gates)
    if ((ins >= n_wires).any() or (outs < 0).any() or (outs >= n_wires).any()):
        raise ValueError("levelize: wire index out of range")
    wire_level = [0] * n_wires
    levels = []
    for ws, out in zip(ins.tolist(), outs.tolist()):
        lv = 1 + max([wire_level[w] for w in ws if w >= 0], default=0)
        wire_level[out] = lv
        levels.append(lv)
    levels = np.array(levels, np.int64)
    return levels, int(levels.max(initial=0))
