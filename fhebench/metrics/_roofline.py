"""The least time a blind rotation can take on one H100: the benchmark's
frozen yardstick.

Frozen copies of ``step_ops``, ``bound`` and the two published peaks of
``rustfhe_tpu_torch/benches/_timing.py`` (as that file stood when the
benchmark was written).  The port's copies may change; these may not.
The count depends only on the parameters and the rows, never on which
kernels ran, so a change that fuses, renames or replaces the rotation's
kernels leaves the yardstick alone.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak of an H100 SXM at 700 W (published)
HBM_BYTES_PER_S = 3.35e12  # device-memory rate of an H100 SXM (published)


def step_ops(p, b: int, steps: int = 1) -> float:
    """The operations of ``steps`` CMux steps of b samples: the two-level
    Karatsuba product's 2 x (2 halves x 4 limbs x 2L x 9 leaves x (N/4)^2)
    per sample and step, the least int8 count the repository shows."""
    return 2.0 * b * steps * 2 * 4 * 2 * p.l * 9 * (p.N // 4) ** 2


def bound(ops: float = 0.0, nbytes: float = 0.0) -> tuple[float, str]:
    """The least time in seconds for ``ops`` int8 operations and ``nbytes``
    of device memory, against the published peaks, and which bounds it."""
    t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rotation_bytes(p, rows: int, tv_rows: int) -> float:
    """The raw bootstrapping key read once (n x 2L x 2 x N words), the
    accumulator written and read once (rows x 2 x N words each way), the
    lv0 inputs the rotation amounts come from (rows x (n+1) words) and the
    test vectors (tv_rows x 2 x N words), 4 bytes a word."""
    words = p.n * 2 * p.l * 2 * p.N + 2 * rows * 2 * p.N + rows * (p.n + 1) + tv_rows * 2 * p.N
    return 4.0 * words


def rotation_least_s(p, rows: int, tv_rows: int) -> float:
    """The least time of one blind rotation of ``rows`` samples."""
    return bound(rows * step_ops(p, 1, p.n), rotation_bytes(p, rows, tv_rows))[0]
