"""The limb-form CMux steps (K4, K6) and external product (K5).

Counterpart of ``rustfhe_tpu/engine/pallas_step.py``, the JAX engine
``"pallas"``: K4 replaces ``fused_cmux_step_merged`` (pallas_step.py:363),
K6 ``fused_cmux_step`` (pallas_step.py:267) and K5
``fused_external_product`` (pallas_step.py:158).  The kernels are CUDA C++
for sm_90a in ``csrc/limb_step.cu`` (with ``csrc/cmux_common.cuh``), built
with nvcc into a shared library with a plain C interface on first use
(``build``) and called through ctypes.  They read the step's doubled int8
limb table of ``plain.prepare_trgsw_limbs``, (2L, 2, 4, 2N).

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain torch version beside it, a CUDA tensor launches the
kernel or raises.  ``cmux_step_merged.launches``,
``cmux_step_split.launches`` and ``external_product.launches`` count the
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import poly
from ..params import TFHEParams
from . import build, cmux_k, plain
from .cmux_k import _check_tensor, _dispatch
from .plain import NUM_LIMBS

TB = 8  # samples per block, as csrc/limb_step.cu


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the library of ``csrc/limb_step.cu``.
    Raises RuntimeError when no CUDA device is available."""
    lib = build.load("limb_step")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    step = [vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_uint, vp]
    lib.rustfhe_limb_cmux_step_merged.argtypes = step
    lib.rustfhe_limb_cmux_step_merged.restype = ci
    lib.rustfhe_limb_cmux_step_split.argtypes = step
    lib.rustfhe_limb_cmux_step_split.restype = ci
    lib.rustfhe_limb_external_product.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.rustfhe_limb_external_product.restype = ci
    lib.rustfhe_limb_smem_optin.argtypes = [ctypes.POINTER(ci)]
    lib.rustfhe_limb_smem_optin.restype = ci
    return lib


def _check(err: int, what: str) -> None:
    cmux_k._check(cmux_k.load_library(), err, what)


def smem_bytes(params: TFHEParams, halves: int) -> int:
    """Shared memory of one block: ``halves`` output halves of the limb
    table (2L planes of K limbs of 2N bytes each) and the tile's digits."""
    two_l, N = 2 * params.l, params.N
    return halves * NUM_LIMBS * two_l * 2 * N + TB * two_l * N


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """The card's opt-in limit of shared memory per block, in bytes."""
    lib = load_library()
    num = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check(lib.rustfhe_limb_smem_optin(ctypes.byref(num)), "shared-memory limit query")
    return num.value


def check_bound(params: TFHEParams) -> None:
    """Raise unless every per-limb plane sum, 2L*N * half_bg * 2^7 at most,
    stays below 2^31: the domain of the JAX engine, whose int8 products
    accumulate in int32 before the limbs recombine."""
    bound = 2 * params.l * params.N * params.half_bg * 128
    if bound >= 1 << 31:
        raise ValueError(f"per-limb sums reach 2L*N*half_bg*128 = {bound} >= 2^31 at "
                         f"N={params.N}, l={params.l}, bgbit={params.bgbit}: outside the "
                         "limb engine's exact int32 range")


def _check_smem(device: torch.device, params: TFHEParams, halves: int, what: str) -> None:
    need = smem_bytes(params, halves)
    limit = smem_optin(device.index if device.index is not None else torch.cuda.current_device())
    if need > limit:
        raise ValueError(f"{what} needs {need} bytes of shared memory per block at "
                         f"N={params.N}, l={params.l}, over the card's opt-in limit of "
                         f"{limit} bytes")


def _check_step(acc, a_tilde, table, params: TFHEParams) -> None:
    B = acc.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    _check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    _check_tensor("table", table, torch.int8, (two_l, 2, NUM_LIMBS, 2 * N), acc.device)
    check_bound(params)


# --------------------------------------------------------------------- #
# K4 and K6: one blind-rotate CMux step in limb form
# --------------------------------------------------------------------- #
def cmux_step_plain(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """The plain version of K4 and K6: acc + ExtProd(key, Decompose(X^{a~}
    * acc - acc)), rotate (gather), difference, decomposition, then
    ``plain.external_product_limbs``."""
    from ..trgsw import decompose_trlwe

    rot = poly.rotate(acc, a_tilde[:, None])
    digits = decompose_trlwe(rot - acc, params).to(torch.int8)
    return acc + plain.external_product_limbs(digits, table)


def _step(entry: str, halves: int, acc, a_tilde, table, params: TFHEParams) -> torch.Tensor:
    _check_smem(acc.device, params, halves, entry)
    lib = load_library()
    out = torch.empty_like(acc)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = getattr(lib, entry)(
            acc.data_ptr(), a_tilde.data_ptr(), table.data_ptr(), out.data_ptr(),
            acc.shape[0], params.N, params.l, params.bgbit, params.decomp_mask, stream)
    _check(err, entry)
    return out


def cmux_step_merged(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """K4, both output halves per block: ``acc`` int32 (B, 2, N), ``a_tilde``
    int32 (B,) in [0, 2N), ``table`` the step's doubled limb table int8
    (2L, 2, 4, 2N).  Returns the new accumulator."""
    _check_step(acc, a_tilde, table, params)
    if not _dispatch(acc.device):
        return cmux_step_plain(acc, a_tilde, table, params)
    out = _step("rustfhe_limb_cmux_step_merged", 2, acc, a_tilde, table, params)
    cmux_step_merged.launches += 1
    return out


def cmux_step_split(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """K6, one output half per block (each block builds the digits again);
    the operands and the result of ``cmux_step_merged``."""
    _check_step(acc, a_tilde, table, params)
    if not _dispatch(acc.device):
        return cmux_step_plain(acc, a_tilde, table, params)
    out = _step("rustfhe_limb_cmux_step_split", 1, acc, a_tilde, table, params)
    cmux_step_split.launches += 1
    return out


cmux_step_merged.launches = 0
cmux_step_split.launches = 0


# --------------------------------------------------------------------- #
# K5: external product of precomputed digits
# --------------------------------------------------------------------- #
# K5's plain version: the limb-by-limb float64 products of engine/plain.py.
external_product_plain = plain.external_product_limbs


def external_product(digits: torch.Tensor, table: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """ExtProd(rows, digits): ``digits`` int8 (B, 2L, N) against the doubled
    limb table ``table`` int8 (2L, 2, 4, 2N).  Returns int32 (B, 2, N)."""
    B = digits.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("digits", digits, torch.int8, (B, two_l, N), digits.device)
    _check_tensor("table", table, torch.int8, (two_l, 2, NUM_LIMBS, 2 * N), digits.device)
    check_bound(params)
    if not _dispatch(digits.device):
        return external_product_plain(digits, table)
    _check_smem(digits.device, params, 1, "rustfhe_limb_external_product")
    lib = load_library()
    out = torch.empty((B, 2, N), dtype=torch.int32, device=digits.device)
    with torch.cuda.device(digits.device):
        stream = torch.cuda.current_stream(digits.device).cuda_stream
        err = lib.rustfhe_limb_external_product(
            digits.data_ptr(), table.data_ptr(), out.data_ptr(), B, N, params.l, stream)
    _check(err, "rustfhe_limb_external_product")
    external_product.launches += 1
    return out


external_product.launches = 0


def reset_counters() -> None:
    cmux_step_merged.launches = 0
    cmux_step_split.launches = 0
    external_product.launches = 0
