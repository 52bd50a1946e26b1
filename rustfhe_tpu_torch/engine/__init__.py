"""Polynomial engines: the registry, the exactness probe and the engine
selector.

Counterpart of ``rustfhe_tpu/engine/__init__.py``.  Two engines are
families of hand-written CUDA kernels, with the plain torch version of
every kernel beside it; a wrapper launches its kernel on a CUDA tensor and
runs the plain version on a CPU tensor:

* ``"cmux_k"`` (``CmuxKEngine``): K1-K3 (``cmux_k``, ``rotate_all_k``) on
  the int32 doubled key table, the counterpart of the JAX engines
  ``pallas_k2`` and ``pallas_k``: the step K1 as one int8 tensor-core
  (``wgmma``) GEMM on key panels built per step, K3 the whole rotation in
  one launch;
* ``"limb"`` (``LimbEngine``): K4-K6 (``limb_step``) on the int8 limb
  table, the counterpart of the JAX engine ``"pallas"``: the steps K4/K6
  as K1's int8 ``wgmma`` GEMM on panels cut from the table, the external
  product K5 (the engine's probe) the same panel and product without the
  add, as K2 is K1's.

Four are the JAX package's generic engines, with its methods
(``prepare_trgsw``, ``external_product_digits``, ``poly_mul_torus_binary``):

* ``"matmul"`` / ``"matmul_bf16"`` (``matmul.MatmulEngine``): one dense
  product per step, on the port's int8 tensor-core GEMM (P7/P9's kernel)
  or a bf16 GEMM with fp32 sums;
* ``"nuss"`` (``transform.NussTransformEngine``): the transform-domain
  product, for direct calls and the probe;
* ``"fft64"`` (``fft64.FFT64Engine``): float64 FFT convolution.

``select_engine`` takes the engine that the JAX cascade's rule names for
the parameters (``engine_for``), or the one asked for, and admits it on a
device only after its external product reproduces the naive mod-2^32
oracle (``oracle``) on every adversarial probe pattern, on that device.
An inexact result or a failed launch raises; nothing cascades to another
engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from .._u32 import from_numpy
from ..params import TFHEParams
from . import cmux_k, limb_step, oracle
from .fft64 import FFT64Engine
from .matmul import MatmulEngine
from .plain import prepare_trgsw, prepare_trgsw_limbs
from .transform import NussTransformEngine


@dataclass(frozen=True)
class CmuxKEngine:
    """K1-K3 on the int32 doubled key table (``plain.prepare_trgsw``)."""

    name: ClassVar[str] = "cmux_k"


@dataclass(frozen=True)
class LimbEngine:
    """K4-K6 on the int8 limb table (``plain.prepare_trgsw_limbs``), with
    the two options of the JAX engine's constructor (``PallasEngine``):
    ``merge_c=False`` runs the c-split step K6 in place of K4, and
    ``fuse_step=False`` runs each step as torch rotation, difference and
    decomposition followed by K5."""

    merge_c: bool = True
    fuse_step: bool = True
    name: ClassVar[str] = "limb"


_ENGINES = {e.name: e for e in (CmuxKEngine(), LimbEngine(), MatmulEngine(),
                                MatmulEngine(limb_bits=4, use_bf16=True),
                                NussTransformEngine(), FFT64Engine())}
# The engines with the JAX package's methods (``prepare_trgsw``,
# ``external_product_digits``); all but "nuss" take ``keys.GenericBK`` keys.
GENERIC = (MatmulEngine, FFT64Engine, NussTransformEngine)


def get_engine(name: str = "cmux_k"):
    if name not in _ENGINES:
        raise KeyError(f"unknown engine {name!r}; have {sorted(_ENGINES)}")
    return _ENGINES[name]


def resolve_engine(engine):
    """Engine name or engine instance (e.g. ``LimbEngine(merge_c=False)``)
    -> engine instance."""
    return get_engine(engine) if isinstance(engine, str) else engine


def engine_for(params: TFHEParams) -> str:
    """The JAX cascade's rule (``select_fast_engine`` on an accelerator,
    ``rustfhe_tpu/engine/__init__.py:221-244``): the Karatsuba engines
    (``"cmux_k"``) where N is a multiple of 128 << levels, at most 2048,
    and the digit tree sums fit int8 (half_bg << levels <= 128), levels 2
    then 1; ``"pallas"`` (``"limb"``) where N is a multiple of 128, at most
    2048, and the digits fit int8; otherwise ``"matmul"`` while its int8
    digits are exact (half_bg <= 128), then ``"matmul_bf16"``."""
    N, hb = params.N, params.half_bg
    if N <= 2048 and any(N % (128 << lv) == 0 and hb << lv <= 128 for lv in (2, 1)):
        return "cmux_k"
    if N <= 2048 and N % 128 == 0 and hb <= 128:
        return "limb"
    return "matmul" if hb <= 128 else "matmul_bf16"


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
                        digits: torch.Tensor, want: torch.Tensor,
                        prepare=prepare_trgsw, digit_dtype=torch.int8) -> tuple[bool, str]:
    """(ok, why): run ``external_product(digits, prepare(rows), params)``
    on the device of ``rows``, the digits as ``digit_dtype`` (int8 for the
    kernels, int32 for the generic engines), and compare with the oracle's
    ``want``.  Exceptions propagate: a kernel that fails to run is not an
    exactness verdict, and is not hidden."""
    got = external_product(digits.to(digit_dtype).contiguous(), prepare(rows), params)
    got = got.cpu()
    if got.shape != want.shape:
        return False, f"wrong output shape {tuple(got.shape)} (want {tuple(want.shape)})"
    bad = got != want
    if bool(bad.any()):
        return False, (f"INEXACT results: {int(bad.sum())}/{bad.numel()} output words "
                       "differ from the mod-2^32 oracle")
    return True, "exact"


def probe_ops(eng, params: TFHEParams):
    """(external_product, prepare, digit dtype) of engine ``eng`` for
    ``engine_probe_result``: K2 or K5 on their tables, or the generic
    engine's own methods."""
    if isinstance(eng, LimbEngine):
        return limb_step.external_product, prepare_trgsw_limbs, torch.int8
    if isinstance(eng, GENERIC):
        return (lambda d, prep, p: eng.external_product_digits(prep, d, p),
                lambda rows: eng.prepare_trgsw(rows, params), torch.int32)
    return cmux_k.external_product, prepare_trgsw, torch.int8


def select_engine(params: TFHEParams, device, engine_name=None) -> str:
    """The engine for ``params`` on ``device``: ``engine_name`` (a name or an
    engine instance) when given, else ``engine_for(params)``.  Admitted
    after its external product (K2, K5 or the generic engine's; the plain
    versions on the CPU) matches the oracle on ``probe_vectors`` there.
    Returns the engine's name; raises RuntimeError when the result is
    inexact."""
    device = torch.device(device)
    eng = resolve_engine(engine_name if engine_name is not None else engine_for(params))
    product, prepare, dtype = probe_ops(eng, params)
    rows_np, digits_np = probe_vectors(params)
    rows = from_numpy(rows_np)
    digits = torch.from_numpy(digits_np)
    want = oracle.external_product(rows, digits)  # ground truth, on the host
    ok, why = engine_probe_result(product, params, rows.to(device), digits.to(device), want,
                                  prepare, dtype)
    if not ok:
        raise RuntimeError(f"the {eng.name} engine's external product on {device} failed the "
                           f"oracle probe: {why}")
    return eng.name


__all__ = ["CmuxKEngine", "LimbEngine", "MatmulEngine", "NussTransformEngine", "FFT64Engine",
           "GENERIC", "get_engine", "resolve_engine", "engine_for",
           "probe_vectors", "engine_probe_result", "probe_ops", "select_engine"]
