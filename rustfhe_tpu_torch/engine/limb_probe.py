"""Measurement variants of the limb CMux step (P5, P6).

Counterpart of two Pallas probe kernels of the JAX package that split the
limb step's time by ablation: P6 ``make_variant``
(``benches/step_breakdown_probe.py:134``, the c-split step without its
products or without its rotation) and P5 ``make_step``
(``benches/limb_order_probe.py:85``, the merged step with the limbs
recombined after every plane or once).  Each variant is K6's or K4's
tensor-core step (``limb_step``: the limb panel, the digits, the ``wgmma``
product with the recombination and the add) with one part changed: P6
"norot" builds the digits of acc itself (``step_digits``), "nodots"
replaces the product with the broadcast add (``nodots``), P5 "j-outer"
drains the product's fragment into the recombination after each plane
(``drain_product``); P6 "full" and P5 "limb-outer" are K6's and K4's
kernels.  CUDA C++ for sm_90a in ``csrc/limb_probe.cu`` on the kernels of
``csrc/cmux_step.cuh``, built with nvcc into a library with a plain C
interface on first use and called through ctypes (``launch``).  They take
K4/K6's operands: acc int32 (B, 2, N), a~ int32 (B,), the doubled limb
table int8 (2L, 2, 4, 2N), at every shape K4/K6 take.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain version beside it, a CUDA tensor launches the
kernels or raises.  ``step_variant.launches`` and ``step_order.launches``
count the steps run on the card (one per call, its three launches
together, as ``limb_step.cmux_step_split.launches`` counts K6's), and
nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .._u32 import wrap
from ..params import TFHEParams
from ..decomp import decompose_trlwe
from . import cmux_k, launch, plain
from .launch import INT, UINT, VP, check_tensor, dispatch
from .limb_step import check_step, cmux_step_plain, merged_product_plain

# P6's variants: (rotate, products).  "full" computes K6's function.
VARIANTS = {"full": (True, True), "nodots": (True, False), "norot": (False, True)}
# P5's recombination orders: "limb-outer" is the TPU's K4's, "j-outer" recombines per plane.
ORDERS = {"limb-outer": False, "j-outer": True}
TM = 128  # coefficients per summed digit in "nodots": the TPU probe's panel depth


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the library of ``csrc/limb_probe.cu``.
    Raises RuntimeError when no CUDA device is available."""
    step = [VP, VP, VP, VP, VP, VP, INT, INT, INT, INT, UINT]
    return launch.bind("limb_probe", {
        "rustfhe_limb_probe_variant": step + [INT, INT, INT, VP],
        "rustfhe_limb_probe_order": step + [INT, VP],
        "rustfhe_limb_probe_digits_norot": [VP, VP, INT, INT, INT, INT, UINT, VP],
        "rustfhe_limb_probe_drain_product": [VP, VP, VP, VP, INT, INT, INT, VP],
        "rustfhe_limb_probe_nodots": [VP, VP, VP, INT, INT, INT, INT, VP]})


# --------------------------------------------------------------------- #
# The pieces that are the probes' own, and their plain versions
# --------------------------------------------------------------------- #
def step_digits_plain(acc: torch.Tensor, a_tilde: torch.Tensor, params: TFHEParams,
                      rotate: bool = True) -> torch.Tensor:
    """The step's digits (``cmux_k.step_digits_plain``), or, without
    ``rotate``, the digits of acc itself: int8 (B, 2L, npad), zeros past N."""
    if rotate:
        return cmux_k.step_digits_plain(acc, a_tilde, params)
    digits = decompose_trlwe(acc, params).to(torch.int8)
    return F.pad(digits, (0, cmux_k.geometry(params.N)[0] - params.N)).contiguous()


def step_digits(acc: torch.Tensor, a_tilde: torch.Tensor, params: TFHEParams,
                rotate: bool = True) -> torch.Tensor:
    """``step_digits_plain``'s function on the device of ``acc``: K1's digit
    kernel, or its instantiation without the rotation (P6 norot)."""
    if rotate:
        return cmux_k.step_digits(acc, a_tilde, params)
    B, N, two_l = acc.shape[0], params.N, 2 * params.l
    check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    if not dispatch(acc.device):
        return step_digits_plain(acc, a_tilde, params, rotate)
    cmux_k.check_shape(N, two_l)
    digits = torch.empty((B, two_l, cmux_k.geometry(N)[0]), dtype=torch.int8, device=acc.device)
    launch.call(load_library(), "rustfhe_limb_probe_digits_norot", acc, digits, B, N, params.l,
                params.bgbit, params.decomp_mask)
    return digits


def drain_product(digits: torch.Tensor, panel: torch.Tensor, acc: torch.Tensor,
                  params: TFHEParams) -> torch.Tensor:
    """P5 j-outer's product, K4's with a drain per plane, on the device of
    ``digits``: its function is K4's product (``limb_step.
    merged_product_plain``, which the CPU runs), since the recombination
    is linear mod 2^32."""
    B, N, two_l = digits.shape[0], params.N, 2 * params.l
    check_tensor("digits", digits, torch.int8, (B, two_l, cmux_k.geometry(N)[0]), digits.device)
    check_tensor("panel", panel, torch.int8, cmux_k.panel_shape(params), digits.device)
    check_tensor("acc", acc, torch.int32, (B, 2, N), digits.device)
    if not dispatch(digits.device):
        return merged_product_plain(digits, panel, acc, params)
    cmux_k.check_shape(N, two_l)
    out = torch.empty_like(acc)
    launch.call(load_library(), "rustfhe_limb_probe_drain_product", digits, panel, acc, out, B,
                N, two_l)
    return out


def nodots_plain(digits: torch.Tensor, acc: torch.Tensor, params: TFHEParams,
                 tm: int = TM) -> torch.Tensor:
    """P6 nodots' part in place of the product: per sample S = the sum over
    planes j and blocks mb of digit mb*tm of plane j (``digits`` int8 (B,
    2L, npad)), and out = acc + sum_k S << 8k (mod 2^32) in both halves."""
    s = digits[:, :, : params.N: tm].to(torch.int64).sum(dim=(1, 2))
    res = s * sum(1 << (plain.LIMB_BITS * k) for k in range(plain.NUM_LIMBS))
    return wrap(acc.to(torch.int64) + res[:, None, None])


def nodots(digits: torch.Tensor, acc: torch.Tensor, params: TFHEParams,
           tm: int = TM) -> torch.Tensor:
    """``nodots_plain``'s function on the device of ``digits``."""
    B, N, two_l = digits.shape[0], params.N, 2 * params.l
    check_tensor("digits", digits, torch.int8, (B, two_l, cmux_k.geometry(N)[0]), digits.device)
    check_tensor("acc", acc, torch.int32, (B, 2, N), digits.device)
    _check_tm(params, tm)
    if not dispatch(digits.device):
        return nodots_plain(digits, acc, params, tm)
    cmux_k.check_shape(N, two_l)
    out = torch.empty_like(acc)
    launch.call(load_library(), "rustfhe_limb_probe_nodots", acc, digits, out, B, N, two_l, tm)
    return out


# --------------------------------------------------------------------- #
# P6 and P5
# --------------------------------------------------------------------- #
def variant_step_plain(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                       params: TFHEParams, rotate: bool, dots: bool, tm: int = TM) -> torch.Tensor:
    """The plain version of P6.  ``rotate`` and ``dots``: K6's plain version
    (``limb_step.cmux_step_plain``).  Without ``rotate`` the digits are those
    of acc itself.  Without ``dots``, ``nodots_plain`` of the step's
    digits."""
    if rotate and dots:
        return cmux_step_plain(acc, a_tilde, table, params)
    digits = step_digits_plain(acc, a_tilde, params, rotate)
    if dots:
        return acc + plain.external_product_limbs(digits[..., : params.N], table)
    return nodots_plain(digits, acc, params, tm)


def _check_tm(params: TFHEParams, tm: int) -> None:
    if tm < 1 or params.N % tm:
        raise ValueError(f"tm={tm} must divide N={params.N}")


def _step(entry: str, acc, a_tilde, table, params: TFHEParams, *flags) -> torch.Tensor:
    """A variant's three launches into the calling thread's digit and panel
    buffers (``cmux_k.step_buffers``, K4/K6's)."""
    B, N, two_l = acc.shape[0], params.N, 2 * params.l
    cmux_k.check_shape(N, two_l)
    if table.data_ptr() % 4:  # the panel kernel reads the table as words
        table = table.clone()
    stream = launch.current_stream(acc.device)
    digits, panel = cmux_k.step_buffers("schoolbook", B, params, acc.device, stream)
    out = torch.empty_like(acc)
    launch.call(load_library(), entry, acc, a_tilde, table, out, digits, panel, B, N, params.l,
                params.bgbit, params.decomp_mask, *flags, stream=stream)
    return out


def step_variant(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                 params: TFHEParams, variant: str = "full", tm: int = TM) -> torch.Tensor:
    """P6: K6's step (one output half per block tile) in one of
    ``VARIANTS``.  Operands and result as ``limb_step.cmux_step_split``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; P6 has {', '.join(VARIANTS)}")
    rotate, dots = VARIANTS[variant]
    check_step(acc, a_tilde, table, params)
    _check_tm(params, tm)
    if not dispatch(acc.device):
        return variant_step_plain(acc, a_tilde, table, params, rotate, dots, tm)
    out = _step("rustfhe_limb_probe_variant", acc, a_tilde, table, params, int(rotate),
                int(dots), tm)
    step_variant.launches += 1
    return out


def step_order(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
               params: TFHEParams, order: str = "limb-outer") -> torch.Tensor:
    """P5: K4's step (both output halves per block tile) with the
    recombination order of ``ORDERS``; both equal K4.  Operands and result
    as ``limb_step.cmux_step_merged``."""
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}; P5 has {', '.join(ORDERS)}")
    check_step(acc, a_tilde, table, params)
    if not dispatch(acc.device):
        return cmux_step_plain(acc, a_tilde, table, params)
    out = _step("rustfhe_limb_probe_order", acc, a_tilde, table, params, int(ORDERS[order]))
    step_order.launches += 1
    return out


def reset_counters() -> None:
    step_variant.launches = 0
    step_order.launches = 0


reset_counters()
