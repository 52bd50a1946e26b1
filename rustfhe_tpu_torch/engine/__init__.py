"""Polynomial engines: the registry, the exactness probe and the engine
selector.

Counterpart of ``rustfhe_tpu/engine/__init__.py``.  Two engines are
families of hand-written CUDA kernels, with the plain torch version of
every kernel beside it; a wrapper launches its kernel on a CUDA tensor and
runs the plain version on a CPU tensor (every wrapper binds, checks and
launches through ``launch``; ``build`` compiles the libraries):

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

``"oracle"`` (``oracle.OracleEngine``) is the naive product behind the same
methods.  ``PolyEngine`` is the protocol of those methods: an engine that
``register_engine`` adds under a name runs through them, as the generic
engines do.

``select_engine`` takes the engine that the JAX cascade's rule names for
the parameters (``engine_for``), or the one asked for (by the caller, or
by ``RUSTFHE_ENGINE`` with the JAX package's names mapped,
``JAX_ENGINE_NAMES``), and admits it on a device only after its external
product reproduces the naive mod-2^32 oracle (``oracle``) on every
adversarial probe pattern, on that device.  An inexact result or a failed
launch raises; nothing cascades to another engine.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import ClassVar, Protocol, runtime_checkable

import numpy as np
import torch

from .._device import resolve_device
from .._u32 import from_numpy
from ..params import DEFAULT_PARAMS, TFHEParams
from ..utils import trace
from . import cmux_k, limb_step, oracle
from .fft64 import FFT64Engine
from .matmul import MatmulEngine
from .oracle import OracleEngine
from .plain import prepare_trgsw, prepare_trgsw_limbs
from .transform import NussTransformEngine


@runtime_checkable
class PolyEngine(Protocol):
    """The generic-engine interface (the JAX package's ``PolyEngine``),
    on int32 words.  ``keys.prepare_cloud_key`` stores
    ``prepare_trgsw(bk_raw)`` as a ``keys.GenericBK`` and
    ``bootstrap.blind_rotate`` calls ``external_product_digits`` on every
    step; ``select_engine`` probes that product.  The K1-K6 engines
    (``CmuxKEngine``, ``LimbEngine``) have their own key tables and do not
    take this path."""

    name: str

    def prepare_trgsw(self, rows: torch.Tensor, params) -> object:
        """The engine's form of TRGSW rows int32 ``(..., 2L, 2, N)``: per
        row j, index 0 the b polynomial and index 1 the a polynomial."""

    def external_product_digits(self, prepared, digits: torch.Tensor,
                                params) -> torch.Tensor:
        """sum_j digits[..., j, :] (*) rows[j] for both output
        polynomials: ``digits`` int32 ``(..., 2L, N)`` (b digits then a
        digits) -> int32 ``(..., 2, N)``."""

    def poly_mul_torus_binary(self, a: torch.Tensor, s: torch.Tensor,
                              params) -> torch.Tensor:
        """Negacyclic product of torus words ``a (..., N)`` by the binary
        polynomial ``s (N,)``, exact mod 2^32."""


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
                                NussTransformEngine(), FFT64Engine(), OracleEngine())}
# The engines of this package with the JAX package's methods
# (``PolyEngine``); all but "nuss" take ``keys.GenericBK`` keys.
GENERIC = (MatmulEngine, FFT64Engine, NussTransformEngine, OracleEngine)
# RUSTFHE_ENGINE's values that name a JAX engine -> the port's engine:
# the Karatsuba kernels ("pallas_k2", "pallas_k") are K1-K3's, the fused
# limb kernels ("pallas") K4-K6's.  Other names pass through.
JAX_ENGINE_NAMES = {"pallas_k2": "cmux_k", "pallas_k": "cmux_k", "pallas": "limb"}


def register_engine(name: str, engine) -> None:
    """Add ``engine`` (a ``PolyEngine``) under ``name``, or replace the one
    there: ``get_engine``, ``resolve_engine`` and so ``TFHE.new`` and
    ``keys.prepare_cloud_key`` find it by that name."""
    _ENGINES[name] = engine


def get_engine(name: str = "cmux_k"):
    if name not in _ENGINES:
        raise KeyError(f"unknown engine {name!r}; have {sorted(_ENGINES)}")
    return _ENGINES[name]


def resolve_engine(engine):
    """Engine name or engine instance (e.g. ``LimbEngine(merge_c=False)``)
    -> engine instance."""
    return get_engine(engine) if isinstance(engine, str) else engine


def requested_engine(params: TFHEParams, engine_name=None):
    """The engine a caller gets for ``params``: ``engine_name`` (a name of
    this package or an engine instance) when given, else the one
    ``RUSTFHE_ENGINE`` names (a JAX engine's name mapped by
    ``JAX_ENGINE_NAMES``), else ``engine_for(params)``.  ``select_engine``
    probes it; the sharded builders (``parallel.sharded``) hold their key
    to it."""
    if engine_name is None:
        env = os.environ.get("RUSTFHE_ENGINE")
        engine_name = JAX_ENGINE_NAMES.get(env, env) if env else engine_for(params)
    return resolve_engine(engine_name)


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
    if isinstance(eng, CmuxKEngine):
        return cmux_k.external_product, prepare_trgsw, torch.int8
    if isinstance(eng, PolyEngine):
        return (lambda d, prep, p: eng.external_product_digits(prep, d, p),
                lambda rows: eng.prepare_trgsw(rows, params), torch.int32)
    raise TypeError(f"{type(eng).__name__} is not an engine: it has no PolyEngine methods")


def select_engine(params: TFHEParams, device, engine_name=None) -> str:
    """The engine for ``params`` on ``device``: ``engine_name`` (a name or an
    engine instance) when given, else the one ``RUSTFHE_ENGINE`` names (a
    JAX name mapped by ``JAX_ENGINE_NAMES``), else ``engine_for(params)``.
    Admitted after its external product (K2, K5 or the generic engine's;
    the plain versions on the CPU) matches the oracle on ``probe_vectors``
    there.  Returns the engine's name; raises RuntimeError when the result
    is inexact, whoever named the engine."""
    device = torch.device(device)
    eng = requested_engine(params, engine_name)
    with trace.span("setup.engine_probe", engine=eng.name):
        ok, why = _probe_engine(eng, params, device)
    if not ok:
        raise RuntimeError(f"the {eng.name} engine's external product on {device} failed the "
                           f"oracle probe: {why}")
    return eng.name


def _probe_engine(eng, params: TFHEParams, device) -> tuple[bool, str]:
    """(ok, why) of engine ``eng`` (a name or an instance) on
    ``probe_vectors(params)`` on ``device``, against the oracle run on the
    host."""
    product, prepare, dtype = probe_ops(resolve_engine(eng), params)
    rows_np, digits_np = probe_vectors(params)
    rows = from_numpy(rows_np)
    digits = torch.from_numpy(digits_np)
    want = oracle.external_product(rows, digits)  # ground truth, on the host
    return engine_probe_result(product, params, rows.to(torch.device(device)),
                               digits.to(torch.device(device)), want, prepare, dtype)


def select_fast_engine(params: TFHEParams | None = None, device="cuda") -> str:
    """The JAX package's name for ``select_engine``: the engine for
    ``params`` (DEFAULT_PARAMS if None) admitted on ``device`` (the card
    unless the caller names the CPU)."""
    return select_engine(params or DEFAULT_PARAMS, resolve_device(device))


__all__ = ["PolyEngine", "CmuxKEngine", "LimbEngine", "MatmulEngine", "NussTransformEngine",
           "FFT64Engine", "OracleEngine", "GENERIC", "JAX_ENGINE_NAMES", "register_engine",
           "get_engine", "resolve_engine", "requested_engine", "engine_for", "probe_vectors",
           "engine_probe_result", "probe_ops", "select_engine", "select_fast_engine"]
