"""The two-level Karatsuba CMux step and its measurement variants (P4, P8,
P1, P2, P3).

Counterpart of five Pallas probe kernels of the JAX package that time its
production K1 at levels 2 (``pallas_k.py:_kernel_step_k``, the engine
``"pallas_k2"``) in the residue layout:

* P4 ``benches/k2_floor_probe.py:164`` ``make_step.step``: ``step_ablate``,
  the step with one part dropped (``ABLATIONS``);
* P8 ``benches/vpu_reduce_probe.py:190`` ``step_var``: ``step_var``, the
  digit extract, the tree sums, the recombination order, the rotation
  skipped, two steps per call;
* P1 ``benches/karatsuba2_probe.py:179`` ``step_k2``: ``step_k2``, the
  limb-outer step with the multiply extract;
* P2 ``benches/coissue_probe.py:114`` ``make_split.step``: ``step_split``,
  the block's tile as two sub-tiles, serial or grouped;
* P3 ``benches/coissue2_probe.py:134`` ``step_coissue``: ``step_coissue``,
  each sum leaf's tree planes built by its own warp just before its
  products (B), or its second plane group between the first group's
  products (C, ``pipelined``).

One kernel family, CUDA C++ for sm_90a in ``csrc/karatsuba_probe.cu``,
built with nvcc on first use and called through ctypes; each form the
entry points run (``FORMS``) is one instantiation.  Operands are in the
JAX package's residue layout: acc int32 (B, 2N) (``karatsuba.scan_enter``),
a~ int32 (B,) in [0, 2N), the leaf table int8 (2, T, K, 2L, 2ns)
(``karatsuba.prepare_table``, or ``table_from_qd`` of a JAX table).

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain version (``karatsuba.step_plain``), a CUDA tensor
launches the kernel or raises.  ``step_ablate.launches``,
``step_var.launches``, ``step_k2.launches``, ``step_split.launches`` and
``step_coissue.launches`` count the kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..params import TFHEParams
from . import build, karatsuba
from .cmux_k import _check_tensor, _dispatch
from .karatsuba import R, T, Step
from .limb_step import TB, _check, smem_optin
from .plain import NUM_LIMBS

TM = 128  # the TPU probes' panel depth: the coefficients per summed digit in "nodots"

# P4's ablations (k2_floor_probe.py:13-19); "full" is the production step.
ABLATIONS = {
    "full": Step(),
    "norot": Step(rot="norot"),
    "noextract": Step(extract="top"),
    "notree": Step(planes=0),
    "nodots": Step(dots=False),
    "norecomb": Step(limbs=1),
    "nocombine": Step(combine=False),
    "accio": Step(accio=True),
}
EXTRACTS = ("mul", "shift", "sar")  # P8's digit extract forms
SPLITS = ("serial", "grouped")  # P2's sub-tile orders
BUILDS = ("leaf", "pipelined")  # P3's forms B and C (coissue2_probe.py:11-12)


def var_form(leaf_combine: bool = True, planes: int = 32, extract: str = "mul",
             skip_rotate: bool = False) -> Step:
    """P8's form (vpu_reduce_probe.py:55-137): multiply extract unless
    asked; ``planes`` 16 takes the tree sums packed (int8x4 ``__vadd4``)."""
    return Step(rot="skip" if skip_rotate else "rotate", extract=extract, planes=planes,
                leaf_first=leaf_combine)


K2_FORM = Step(extract="mul", leaf_first=False)  # P1: karatsuba2_probe.py:110-170
# P8's single-step forms as its script runs them (vpu_reduce_probe.py:253-301):
# step_var's keywords.
VAR_FORMS = {
    "leaf_u32": {}, "limb_outer": dict(leaf_combine=False), "int16": dict(planes=16),
    "shift": dict(extract="shift"), "int16+shift": dict(planes=16, extract="shift"),
    "sar": dict(extract="sar"), "skip_rotate": dict(skip_rotate=True),
    "skip_rotate+sar": dict(skip_rotate=True, extract="sar"),
}
COISSUE_FORMS = {b: Step(extract="mul", build=b) for b in BUILDS}  # P3, the mul extract
# The forms the kernel carries: those the five entry points run.
FORMS = frozenset(list(ABLATIONS.values()) + [var_form(**kw) for kw in VAR_FORMS.values()]
                  + [K2_FORM] + [Step(extract="mul", split=s) for s in SPLITS]
                  + list(COISSUE_FORMS.values()))


def calls() -> list:
    """Every single-step call the five entry points make, as (probe, label,
    wrapper, keywords, form): ``wrapper(acc, a_tilde, table, params,
    **keywords)`` computes ``karatsuba.step_plain(..., form)``."""
    out = [("P4", v, step_ablate, dict(variant=v), f) for v, f in ABLATIONS.items()]
    out += [("P8", tag, step_var, kw, var_form(**kw)) for tag, kw in VAR_FORMS.items()]
    out.append(("P1", "step_k2", step_k2, {}, K2_FORM))
    out += [("P2", s, step_split, dict(grouped=bool(g)), Step(extract="mul", split=s))
            for g, s in enumerate(SPLITS)]
    out += [("P3", b, step_coissue, dict(pipelined=bool(g)), COISSUE_FORMS[b])
            for g, b in enumerate(BUILDS)]
    return out

_BITS = (("rot", {"rotate": 0, "norot": 1, "skip": 2}, 0),
         ("extract", {"sar": 0, "mul": 1, "shift": 2, "top": 3}, 2),
         ("planes", {32: 0, 16: 1, 0: 2}, 4),
         ("split", {"": 0, "serial": 1, "grouped": 2}, 10),
         ("build", {"upfront": 0, "leaf": 1, "pipelined": 2}, 13))


def form_code(v: Step) -> int:
    """The form's number in ``csrc/karatsuba_probe.cu`` (its bits)."""
    code = sum(table[getattr(v, name)] << shift for name, table, shift in _BITS)
    return (code | (not v.dots) << 6 | (v.limbs == 1) << 7 | (not v.leaf_first) << 8
            | (not v.combine) << 9 | v.accio << 12)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the library of ``csrc/karatsuba_probe.cu``.
    Raises RuntimeError when no CUDA device is available."""
    lib = build.load("karatsuba_probe")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rustfhe_karatsuba_step.argtypes = [vp, vp, ci, vp, vp, ci, ci, ci, ci, ctypes.c_uint,
                                           ci, ci, vp]
    lib.rustfhe_karatsuba_step.restype = ci
    return lib


def smem_bytes(params: TFHEParams) -> int:
    """Shared memory of one block: one output half of the leaf table, the
    tile's digit trees and one sample's leaves for the combine."""
    ns, two_l = params.N // R, 2 * params.l
    return T * NUM_LIMBS * two_l * 2 * ns + TB * T * two_l * ns + T * ns * 4


def _check_operands(acc, a_tilde, table, params: TFHEParams, unroll: int = 1) -> None:
    B = acc.shape[0]
    _check_tensor("acc", acc, torch.int32, (B, 2 * params.N), acc.device)
    a_shape, t_shape = (B,), karatsuba.table_shape(params)
    if unroll > 1:
        a_shape, t_shape = (B, unroll), (unroll,) + t_shape
    _check_tensor("a_tilde", a_tilde, torch.int32, a_shape, acc.device)
    _check_tensor("table", table, torch.int8, t_shape, acc.device)
    karatsuba.check_bound(params)


def _launch(v: Step, acc, a_tilde, table, params: TFHEParams, tm: int = TM,
            a_stride: int = 1, a_offset: int = 0) -> torch.Tensor:
    """One launch of form ``v`` on the card; a~ of sample b is
    ``a_tilde[b * a_stride + a_offset]`` (flat)."""
    if v not in FORMS:
        raise ValueError(f"the Karatsuba kernel carries no form {v}")
    ns = params.N // R
    if params.N % (R * 8) or ns > 256:
        raise ValueError(f"the Karatsuba kernel takes N a multiple of 32 up to 1024, got "
                         f"N={params.N}")
    need = 0 if v.accio else smem_bytes(params)
    limit = smem_optin(acc.device.index if acc.device.index is not None
                       else torch.cuda.current_device())
    if need > limit:
        raise ValueError(f"the Karatsuba step needs {need} bytes of shared memory per block at "
                         f"N={params.N}, l={params.l}, over the card's opt-in limit of "
                         f"{limit} bytes")
    lib = load_library()
    out = torch.empty_like(acc)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.rustfhe_karatsuba_step(
            acc.data_ptr(), a_tilde.data_ptr() + 4 * a_offset, a_stride, table.data_ptr(),
            out.data_ptr(), acc.shape[0], params.N, params.l, params.bgbit,
            params.decomp_mask, form_code(v), tm, stream)
    _check(err, f"rustfhe_karatsuba_step ({v})")
    return out


def _check_tm(params: TFHEParams, tm: int) -> None:
    ns = params.N // R
    if tm < 1 or ns % tm:
        raise ValueError(f"tm={tm} must divide the leaf size ns={ns}")


def step_ablate(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                params: TFHEParams, variant: str = "full", tm: int = TM) -> torch.Tensor:
    """P4: the production Karatsuba step (shift-up, arithmetic-shift-down
    digit extract, leaf-first recombination) in one of ``ABLATIONS``.
    ``tm`` is the TPU probe's panel depth, which only "nodots" reads."""
    if variant not in ABLATIONS:
        raise ValueError(f"unknown variant {variant!r}; P4 has {', '.join(ABLATIONS)}")
    _check_operands(acc, a_tilde, table, params)
    _check_tm(params, tm)
    v = ABLATIONS[variant]
    if not _dispatch(acc.device):
        return karatsuba.step_plain(acc, a_tilde, table, params, v, tm)
    out = _launch(v, acc, a_tilde, table, params, tm)
    step_ablate.launches += 1
    return out


def step_var(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
             params: TFHEParams, leaf_combine: bool = True, planes: int = 32,
             extract: str = "mul", unroll: int = 1, skip_rotate: bool = False) -> torch.Tensor:
    """P8: the step with its digit-side work varied (``var_form``).  With
    ``unroll=2``, a~ is (B, 2) and ``table`` the two steps' tables stacked
    (2, ...); the result is two steps.  A block holds one output half, and
    step 2's digits need both: no layout keeps the intermediate
    accumulator on chip within the shared memory of a block, so the card
    runs two launches."""
    if unroll not in (1, 2):
        raise ValueError(f"unroll must be 1 or 2, got {unroll}")
    _check_operands(acc, a_tilde, table, params, unroll)
    v = var_form(leaf_combine, planes, extract, skip_rotate)
    if v not in FORMS:
        raise ValueError(f"P8 runs no form {v}")
    if planes == 16 and params.l > 4:
        raise ValueError(f"packed tree sums hold 4 levels in a word, got l={params.l}")
    if unroll == 2:
        for s in range(2):
            acc = _step_var1(acc, a_tilde, table[s], params, v, s)
        return acc
    return _step_var1(acc, a_tilde, table, params, v, None)


def _step_var1(acc, a_tilde, table, params, v: Step, col) -> torch.Tensor:
    if not _dispatch(acc.device):
        a = a_tilde if col is None else a_tilde[:, col]
        return karatsuba.step_plain(acc, a, table, params, v)
    if col is None:
        out = _launch(v, acc, a_tilde, table, params)
    else:
        out = _launch(v, acc, a_tilde, table, params, a_stride=2, a_offset=col)
    step_var.launches += 1
    return out


def step_k2(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
            params: TFHEParams) -> torch.Tensor:
    """P1: the limb-outer Karatsuba step with the multiply extract (one
    tree combine per limb, then the limbs recombine)."""
    _check_operands(acc, a_tilde, table, params)
    if not _dispatch(acc.device):
        return karatsuba.step_plain(acc, a_tilde, table, params, K2_FORM)
    out = _launch(K2_FORM, acc, a_tilde, table, params)
    step_k2.launches += 1
    return out


def step_split(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
               params: TFHEParams, grouped: bool = False) -> torch.Tensor:
    """P2: the step (multiply extract, leaf-first) with the block's tile of
    8 samples taken as two sub-tiles of 4: serially (digits, products,
    digits, products) or grouped (both digit builds first)."""
    _check_operands(acc, a_tilde, table, params)
    v = Step(extract="mul", split=SPLITS[grouped])
    if not _dispatch(acc.device):
        return karatsuba.step_plain(acc, a_tilde, table, params, v)
    out = _launch(v, acc, a_tilde, table, params)
    step_split.launches += 1
    return out


def step_coissue(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                 params: TFHEParams, pipelined: bool = False) -> torch.Tensor:
    """P3: the step (multiply extract, leaf-first) with each sum leaf's
    tree planes built by its own warp after the block's residue digits:
    the whole leaf before its products (B), or, ``pipelined`` (C), its
    second plane group in chunks between the first group's products."""
    _check_operands(acc, a_tilde, table, params)
    v = COISSUE_FORMS[BUILDS[pipelined]]
    if not _dispatch(acc.device):
        return karatsuba.step_plain(acc, a_tilde, table, params, v)
    out = _launch(v, acc, a_tilde, table, params)
    step_coissue.launches += 1
    return out


def reset_counters() -> None:
    for fn in (step_ablate, step_var, step_k2, step_split, step_coissue):
        fn.launches = 0


reset_counters()
