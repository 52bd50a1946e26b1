"""Polynomial engine: the exactness probe and the engine selector.

Counterpart of ``rustfhe_tpu/engine/__init__.py``.  The port has one
engine, dispatched by device: on a CUDA tensor the hand-written kernels of
``cmux_k`` (K1, K2), on a CPU tensor their plain torch versions
(``plain``).  ``select_engine`` admits it on a device only after K2
reproduces the naive mod-2^32 oracle (``oracle``) on every adversarial
probe pattern, on that device.  An inexact result or a failed launch
raises; nothing cascades to another engine.
"""

from __future__ import annotations

import numpy as np
import torch

from .._u32 import from_numpy
from ..params import TFHEParams
from . import cmux_k, oracle
from .plain import prepare_trgsw


def probe_vectors(params: TFHEParams):
    """Adversarial (rows, digits) exactness-probe vectors, the same bits as
    the JAX package's ``probe_vectors`` (``np.random.RandomState(1234)``).

    The set stresses limb and sign edges (row bytes 0x80, 0x7F, 0xFF, 0x00
    and edge words), accumulator-magnitude extremes (every digit at -half_bg
    against all-ones rows) and the digit boundaries -half_bg and
    half_bg - 1.  Returns (rows uint32 (2L, 2, N), digits int32 (P, 2L, N)).
    """
    shape_r = (2 * params.l, 2, params.N)
    size_r = int(np.prod(shape_r))
    rs = np.random.RandomState(1234)

    byte_edges = np.array([0x00, 0x01, 0x7F, 0x80, 0xFE, 0xFF], np.uint32)
    word_edges = np.array(
        [0x00000000, 0x00000001, 0x7FFFFFFF, 0x80000000, 0x80808080, 0xFFFFFFFF],
        np.uint32,
    )
    b = byte_edges[np.arange(size_r * 4) % len(byte_edges)].reshape(size_r, 4)
    rows = np.empty(size_r, np.uint32)
    third = size_r // 3
    rows[:third] = rs.randint(0, 2**32, size=third, dtype=np.uint64).astype(np.uint32)
    rows[third: 2 * third] = word_edges[np.arange(third) % len(word_edges)]
    rest = size_r - 2 * third
    rows[2 * third:] = (
        b[:rest, 0] | (b[:rest, 1] << 8) | (b[:rest, 2] << 16) | (b[:rest, 3] << 24)
    )
    rows = rows.reshape(shape_r)

    hb = params.half_bg
    shape_d = (2 * params.l, params.N)
    digits = np.stack(
        [
            rs.randint(-hb, hb, size=shape_d),
            np.full(shape_d, -hb),
            np.full(shape_d, hb - 1),
            np.where(np.arange(params.N) % 2 == 0, -hb, hb - 1) * np.ones(shape_d, int),
        ]
    ).astype(np.int32)
    return rows, digits


def engine_probe_result(external_product, params: TFHEParams, rows: torch.Tensor,
                        digits: torch.Tensor, want: torch.Tensor) -> tuple[bool, str]:
    """(ok, why): run ``external_product(digits_int8, prepared_rows, params)``
    on the device of ``rows`` and compare with the oracle's ``want``.
    Exceptions propagate: a kernel that fails to run is not an exactness
    verdict, and is not hidden."""
    got = external_product(digits.to(torch.int8).contiguous(), prepare_trgsw(rows), params)
    got = got.cpu()
    if got.shape != want.shape:
        return False, f"wrong output shape {tuple(got.shape)} (want {tuple(want.shape)})"
    bad = got != want
    if bool(bad.any()):
        return False, (f"INEXACT results: {int(bad.sum())}/{bad.numel()} output words "
                       "differ from the mod-2^32 oracle")
    return True, "exact"


def select_engine(params: TFHEParams, device) -> str:
    """Admit the engine on ``device`` after K2 (or its plain version on the
    CPU) matches the oracle on ``probe_vectors`` there.  Returns the engine
    name ("cmux_k" for the CUDA kernels, "plain" on the CPU); raises
    RuntimeError when the result is inexact."""
    device = torch.device(device)
    rows_np, digits_np = probe_vectors(params)
    rows = from_numpy(rows_np)
    digits = torch.from_numpy(digits_np)
    want = oracle.external_product(rows, digits)  # ground truth, on the host
    ok, why = engine_probe_result(cmux_k.external_product, params, rows.to(device),
                                  digits.to(device), want)
    if not ok:
        raise RuntimeError(f"the external product on {device} failed the oracle probe: {why}")
    return "cmux_k" if device.type == "cuda" else "plain"


__all__ = ["probe_vectors", "engine_probe_result", "select_engine"]
