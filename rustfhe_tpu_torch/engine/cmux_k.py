"""The blind-rotate CMux step (K1) and the external product (K2).

Counterpart of ``rustfhe_tpu/engine/pallas_k.py``: K1 replaces
``fused_cmux_step_k`` (pallas_k.py:295) and K2 ``fused_external_product_k``
(pallas_k.py:506).  The kernels are CUDA C++ for sm_90a in
``csrc/cmux_k.cu`` (with ``csrc/cmux_common.cuh``), built with nvcc into a
shared library with a plain C interface on first use (``build``) and
called through ctypes.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain torch version beside it, a CUDA tensor launches the
kernel or raises.  There is no fallback from a failed launch to the plain
version.  ``cmux_step.launches`` and ``external_product.launches`` count the
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import poly
from ..params import TFHEParams
from . import build, plain


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the library of ``csrc/cmux_k.cu``.
    Raises RuntimeError when no CUDA device is available."""
    lib = build.load("cmux_k")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rustfhe_cmux_step_k.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_uint, vp]
    lib.rustfhe_cmux_step_k.restype = ci
    lib.rustfhe_external_product_k.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.rustfhe_external_product_k.restype = ci
    lib.rustfhe_cuda_error_string.argtypes = [ci]
    lib.rustfhe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.rustfhe_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _dispatch(device: torch.device) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


# --------------------------------------------------------------------- #
# K1: one blind-rotate CMux step
# --------------------------------------------------------------------- #
def cmux_step_plain(acc: torch.Tensor, a_tilde: torch.Tensor, key: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """acc + ExtProd(key, Decompose(X^{a~} * acc - acc)): rotate (gather),
    difference, decomposition, then ``plain.external_product``."""
    from ..trgsw import decompose_trlwe

    rot = poly.rotate(acc, a_tilde[:, None])
    digits = decompose_trlwe(rot - acc, params).to(torch.int8)
    return acc + plain.external_product(digits, key)


def cmux_step(acc: torch.Tensor, a_tilde: torch.Tensor, key: torch.Tensor,
              params: TFHEParams) -> torch.Tensor:
    """One blind-rotate step for a batch: ``acc`` int32 (B, 2, N), ``a_tilde``
    int32 (B,) in [0, 2N), ``key`` the step's doubled TRGSW table int32
    (2L, 2, 2N) (``plain.prepare_trgsw``).  Returns the new accumulator."""
    B = acc.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    _check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    _check_tensor("key", key, torch.int32, (two_l, 2, 2 * N), acc.device)
    if not _dispatch(acc.device):
        return cmux_step_plain(acc, a_tilde, key, params)
    lib = load_library()
    out = torch.empty_like(acc)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.rustfhe_cmux_step_k(
            acc.data_ptr(), a_tilde.data_ptr(), key.data_ptr(), out.data_ptr(),
            B, N, params.l, params.bgbit, params.decomp_mask, stream)
    _check(lib, err, "cmux_step_k")
    cmux_step.launches += 1
    return out


cmux_step.launches = 0


# --------------------------------------------------------------------- #
# K2: external product of precomputed digits
# --------------------------------------------------------------------- #
# K2's plain version: the float64 GEMM of engine/plain.py.
external_product_plain = plain.external_product


def external_product(digits: torch.Tensor, key: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """ExtProd(rows, digits): ``digits`` int8 (B, 2L, N) against the doubled
    TRGSW table ``key`` int32 (2L, 2, 2N).  Returns int32 (B, 2, N)."""
    B = digits.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("digits", digits, torch.int8, (B, two_l, N), digits.device)
    _check_tensor("key", key, torch.int32, (two_l, 2, 2 * N), digits.device)
    if not _dispatch(digits.device):
        return external_product_plain(digits, key)
    lib = load_library()
    out = torch.empty((B, 2, N), dtype=torch.int32, device=digits.device)
    with torch.cuda.device(digits.device):
        stream = torch.cuda.current_stream(digits.device).cuda_stream
        err = lib.rustfhe_external_product_k(
            digits.data_ptr(), key.data_ptr(), out.data_ptr(), B, N, two_l, stream)
    _check(lib, err, "external_product_k")
    external_product.launches += 1
    return out


external_product.launches = 0


def reset_counters() -> None:
    cmux_step.launches = 0
    external_product.launches = 0

