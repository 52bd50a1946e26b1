"""Measurement variants of the limb CMux step (P5, P6).

Counterpart of two Pallas probe kernels of the JAX package that split the
limb step's time by ablation: P6 ``make_variant``
(``benches/step_breakdown_probe.py:134``, the c-split step without its
products or without its rotation) and P5 ``make_step``
(``benches/limb_order_probe.py:85``, the merged step with the limbs
recombined after every plane or once).  The probes keep the ``__dp4a``
form of the limb step (the table in shared memory, the digits built in the
block), and their full forms are held to K6 and K4, now an int8 ``wgmma``
GEMM (``limb_step``), word for word.  The kernels are CUDA C++ for sm_90a
in ``csrc/limb_probe.cu``, on the shared code of ``csrc/limb_common.cuh``
that K5 compiles, built with nvcc into a library with a plain C interface
on first use and called through ctypes.  They take K4/K6's operands: acc
int32 (B, 2, N), a~ int32 (B,), the doubled limb table int8 (2L, 2, 4, 2N).

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain version beside it, a CUDA tensor launches the
kernel or raises.  ``step_variant.launches`` and ``step_order.launches``
count the kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import poly
from .._u32 import wrap
from ..params import TFHEParams
from . import build, plain
from .cmux_k import _dispatch
from .limb_step import _check, _check_smem, _check_step, cmux_step_plain

# P6's variants: (rotate, products).  "full" computes K6's function.
VARIANTS = {"full": (True, True), "nodots": (True, False), "norot": (False, True)}
# P5's recombination orders: "limb-outer" is the TPU's K4's, "j-outer" recombines per plane.
ORDERS = {"limb-outer": False, "j-outer": True}
TM = 128  # coefficients per summed digit in "nodots": the TPU probe's panel depth


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the library of ``csrc/limb_probe.cu``.
    Raises RuntimeError when no CUDA device is available."""
    lib = build.load("limb_probe")
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.rustfhe_limb_probe_variant.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, cu, ci, ci, ci, vp]
    lib.rustfhe_limb_probe_variant.restype = ci
    lib.rustfhe_limb_probe_order.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, cu, ci, vp]
    lib.rustfhe_limb_probe_order.restype = ci
    return lib


def variant_step_plain(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                       params: TFHEParams, rotate: bool, dots: bool, tm: int = TM) -> torch.Tensor:
    """The plain version of P6.  ``rotate`` and ``dots``: K6's plain version
    (``limb_step.cmux_step_plain``).  Without ``rotate`` the digits are those
    of acc itself.  Without ``dots``, per sample S = the sum over planes j
    and blocks mb of digit mb*tm of plane j, and out = acc + sum_k S << 8k
    (mod 2^32) in both halves."""
    from ..trgsw import decompose_trlwe

    if rotate and dots:
        return cmux_step_plain(acc, a_tilde, table, params)
    src = poly.rotate(acc, a_tilde[:, None]) - acc if rotate else acc
    digits = decompose_trlwe(src, params).to(torch.int8)
    if dots:
        return acc + plain.external_product_limbs(digits, table)
    s = digits[:, :, ::tm].to(torch.int64).sum(dim=(1, 2))
    res = s * sum(1 << (plain.LIMB_BITS * k) for k in range(plain.NUM_LIMBS))
    return wrap(acc.to(torch.int64) + res[:, None, None])


def _check_tm(params: TFHEParams, tm: int) -> None:
    if tm < 1 or params.N % tm:
        raise ValueError(f"tm={tm} must divide N={params.N}")


def step_variant(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                 params: TFHEParams, variant: str = "full", tm: int = TM) -> torch.Tensor:
    """P6: the c-split limb step (one output half per block) in one of
    ``VARIANTS``.  Operands and result as ``limb_step.cmux_step_split``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; P6 has {', '.join(VARIANTS)}")
    rotate, dots = VARIANTS[variant]
    _check_step(acc, a_tilde, table, params)
    _check_tm(params, tm)
    if not _dispatch(acc.device):
        return variant_step_plain(acc, a_tilde, table, params, rotate, dots, tm)
    _check_smem(acc.device, params, 1, "rustfhe_limb_probe_variant")
    lib = load_library()
    out = torch.empty_like(acc)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.rustfhe_limb_probe_variant(
            acc.data_ptr(), a_tilde.data_ptr(), table.data_ptr(), out.data_ptr(), acc.shape[0],
            params.N, params.l, params.bgbit, params.decomp_mask, int(rotate), int(dots), tm,
            stream)
    _check(err, f"rustfhe_limb_probe_variant ({variant})")
    step_variant.launches += 1
    return out


def step_order(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
               params: TFHEParams, order: str = "limb-outer") -> torch.Tensor:
    """P5: the merged limb step (both output halves per block) with the
    recombination order of ``ORDERS``; both equal K4.  Operands and result
    as ``limb_step.cmux_step_merged``."""
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}; P5 has {', '.join(ORDERS)}")
    _check_step(acc, a_tilde, table, params)
    if not _dispatch(acc.device):
        return cmux_step_plain(acc, a_tilde, table, params)
    _check_smem(acc.device, params, 2, "rustfhe_limb_probe_order")
    lib = load_library()
    out = torch.empty_like(acc)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.rustfhe_limb_probe_order(
            acc.data_ptr(), a_tilde.data_ptr(), table.data_ptr(), out.data_ptr(), acc.shape[0],
            params.N, params.l, params.bgbit, params.decomp_mask, int(ORDERS[order]), stream)
    _check(err, f"rustfhe_limb_probe_order ({order})")
    step_order.launches += 1
    return out


step_variant.launches = 0
step_order.launches = 0


def reset_counters() -> None:
    step_variant.launches = 0
    step_order.launches = 0
