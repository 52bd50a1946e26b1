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
  the product's block tile as two sub-tiles, in turn or together;
* P3 ``benches/coissue2_probe.py:134`` ``step_coissue``: ``step_coissue``,
  the sum leaves' tree planes built by the product's producer warpgroup
  from the residue leaves, stage by stage (B), or with the stage's key
  boxes requested before the build (C, ``pipelined``).

CUDA C++ for sm_90a in ``csrc/karatsuba_probe.cu``, built with nvcc on
first use and called through ctypes; each form the entry points run
(``FORMS``) is one instantiation.  A step is four launches (the nine
leaves' products on the tensor cores, ``wgmma``): the tree digits
(``tree_digits``), the leaf panels (``leaf_panel``), the leaf products in
one launch (``leaves``; the broadcast parts for "nodots") and the tree
combine with the add (``combine``); each piece has its plain version
beside it.  Operands are in the JAX package's residue layout: acc int32
(B, 2N) (``karatsuba.scan_enter``), a~ int32 (B,) in [0, 2N), the leaf
table int8 (2, T, K, 2L, 2ns) (``karatsuba.prepare_table``, or
``table_from_qd`` of a JAX table).  N is a power of two in [32, 2048]
(leaf size ns = N/4 up to 512: PBS_PARAMS included) wherever
``karatsuba.check_bound`` holds.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain version (``karatsuba.step_plain``), a CUDA tensor
launches the kernels or raises.  ``step_ablate.launches``,
``step_var.launches``, ``step_k2.launches``, ``step_split.launches`` and
``step_coissue.launches`` count the steps run on the card (one per step,
its four launches together, as ``cmux_k.cmux_step.launches`` counts K1's
steps: an ``unroll=2`` call counts two), and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from .._u32 import wrap
from ..params import TFHEParams
from . import build, cmux_k, karatsuba, limb_step
from .cmux_k import _check_tensor, _dispatch
from .karatsuba import R, T, Step
from .plain import NUM_LIMBS

TM = 128  # the TPU probes' panel depth: the coefficients per summed digit in "nodots"
MIN_N, MAX_N = 32, 2048  # ring degrees: leaf size ns = N/4 in [8, 512]
RESIDUE_LEAVES = (0, 1, 3, 4)  # the leaves that are one residue (r0, r2, r1, r3)

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
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    for name, args in (
            ("rustfhe_karatsuba_step", [vp, vp, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, cu, ci, ci,
                                        vp]),
            ("rustfhe_karatsuba_tree_digits", [vp, vp, vp, ci, ci, ci, ci, cu, ci, vp]),
            ("rustfhe_karatsuba_leaf_panel", [vp, vp, ci, ci, vp]),
            ("rustfhe_karatsuba_leaf_product", [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]),
            ("rustfhe_karatsuba_combine", [vp, vp, vp, ci, ci, ci, ci, vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ci
    return lib


# --------------------------------------------------------------------- #
# The step's shapes
# --------------------------------------------------------------------- #
def check_shape(params: TFHEParams) -> None:
    """Raise ValueError unless the kernels take the step: N a power of two
    in [MIN_N, MAX_N] and the digit tree and the leaf sums in range
    (``karatsuba.check_bound``)."""
    N = params.N
    if not MIN_N <= N <= MAX_N or N & (N - 1):
        raise ValueError(f"the Karatsuba kernels take N a power of two in [{MIN_N}, {MAX_N}], "
                         f"got N={N}")
    karatsuba.check_bound(params)


def digit_shape(params: TFHEParams, B: int) -> tuple[int, ...]:
    """The tree digits: (B, T, 2L, npad) int8, npad = ns rounded up to 128."""
    return (B, T, 2 * params.l, cmux_k.geometry(params.N // R)[0])


def panel_shape(params: TFHEParams) -> tuple[int, ...]:
    """The leaf panels: (T, 2L, 2, K, rows, 128) int8 (K4's panels at N := ns
    for each leaf)."""
    return (T,) + cmux_k.panel_shape(params.replace(N=params.N // R))


def leaf_shape(params: TFHEParams, B: int, v: Step) -> tuple[int, ...]:
    """The leaves form ``v`` writes: (B, T, 2, ns) words; (B, T, 2, K, ns)
    int32 limb-outer; nodots' broadcast parts flat, W (2, T, K, ns) then D
    (B, T) int32."""
    ns = params.N // R
    if not v.dots:
        return (2 * T * NUM_LIMBS * ns + B * T,)
    return (B, T, 2, NUM_LIMBS, ns) if not v.leaf_first else (B, T, 2, ns)


# --------------------------------------------------------------------- #
# The pieces of a step and their plain versions
# --------------------------------------------------------------------- #
def tree_digits_plain(acc: torch.Tensor, a_tilde: torch.Tensor, params: TFHEParams,
                      v: Step = Step()) -> torch.Tensor:
    """The tree digits of form ``v`` (``karatsuba.step_digits``) as int8
    ``digit_shape``, zeros past ns.  The kernels of P3's forms write the
    ``RESIDUE_LEAVES`` alone."""
    npad = digit_shape(params, 1)[-1]
    dig = karatsuba.step_digits(acc, a_tilde, params, v).to(torch.int8)
    return F.pad(dig, (0, npad - dig.shape[-1])).contiguous()


def leaf_panel_plain(table: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """The leaf panels of the leaf table ``table`` int8 (2, T, K, 2L, 2ns):
    ``panel_shape`` with panel[t, j, c, k, x - x0, r] = table[c, t, k, j,
    x - r] (r < ns, x < 2ns), zeros elsewhere (``limb_step.
    limb_panel_plain`` at N := ns)."""
    ns_params = params.replace(N=params.N // R)
    return limb_step.limb_panel_plain(table.permute(1, 3, 0, 2, 4), ns_params)


def leaves_plain(digits: torch.Tensor, panel: torch.Tensor, table: torch.Tensor,
                 params: TFHEParams, v: Step = Step(), tm: int = TM) -> torch.Tensor:
    """The leaves of form ``v`` as the kernels form them (``leaf_shape``):
    each leaf's product from its digits and panels (``cmux_k.
    panel_parts_plain`` at N := ns), its limbs recombined mod 2^32, or limb
    0 alone (``limbs`` 1), or each limb's int32 sum (limb-outer); for
    nodots, the broadcast parts flat: W[c, t, k, n] = sum_j sum_mb
    L_tckj[n - mb tm + ns] of ``table``, then D[b, t] = sum_j sum_mb digit
    mb*tm of leaf t's plane j (``karatsuba.leaf_parts``' two parts)."""
    ns = params.N // R
    if not v.dots:
        n = torch.arange(ns, device=table.device)
        i = torch.arange(0, ns, tm, device=table.device)
        w = table[..., n[None, :] - i[:, None] + ns].to(torch.int64).sum(dim=(3, 4))
        d = digits[..., :ns:tm].to(torch.int64).sum(dim=(2, 3))  # (B, T)
        return torch.cat([w.flatten(), d.flatten()]).to(torch.int32)
    parts = torch.stack([cmux_k.panel_parts_plain(digits[:, t], panel[t], ns) for t in range(T)],
                        dim=1)  # (B, T, 2, K, ns)
    if not v.leaf_first:
        return parts.to(torch.int32)
    return wrap(sum(parts[:, :, :, k] << (8 * k) for k in range(v.limbs)))


def combine_plain(acc: torch.Tensor, leaves: torch.Tensor, params: TFHEParams,
                  v: Step = Step()) -> torch.Tensor:
    """acc plus the tree combine of ``leaves`` (``leaves_plain``'s layout of
    form ``v``; for nodots each leaf is sum_k (D[b, t] + W[c, t, k, n]) << 8k)."""
    ns = params.N // R
    if not v.dots:
        nw = 2 * T * NUM_LIMBS * ns
        w = leaves[:nw].to(torch.int64).reshape(2, T, NUM_LIMBS, ns)
        d = leaves[nw:].to(torch.int64).reshape(-1, T)
        part = d[:, :, None, None, None] + w.transpose(0, 1)[None]
        return karatsuba.combine_parts(acc, part, v)
    if not v.leaf_first:
        return karatsuba.combine_parts(acc, leaves.to(torch.int64), v)
    # recombined leaves (or limb 0 alone): one part each, unshifted
    return karatsuba.combine_parts(acc, leaves.to(torch.int64)[:, :, :, None],
                                   dataclasses.replace(v, limbs=1))


def tree_digits(acc: torch.Tensor, a_tilde: torch.Tensor, params: TFHEParams,
                v: Step = Step()) -> torch.Tensor:
    """``tree_digits_plain``'s function on the device of ``acc`` (the
    kernel of P3's forms writes the residue leaves alone; the others stay
    as ``torch.empty`` left them)."""
    _check_piece_form(v)
    B = acc.shape[0]
    _check_tensor("acc", acc, torch.int32, (B, 2 * params.N), acc.device)
    _check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    check_shape(params)
    if not _dispatch(acc.device):
        return tree_digits_plain(acc, a_tilde, params, v)
    digits = torch.empty(digit_shape(params, B), dtype=torch.int8, device=acc.device)
    cmux_k._launch("karatsuba_tree_digits", load_library().rustfhe_karatsuba_tree_digits, acc,
                   a_tilde, digits, B, params.N, params.l, params.bgbit, params.decomp_mask,
                   form_code(v))
    return digits


def leaf_panel(table: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """``leaf_panel_plain``'s function on the device of ``table``."""
    _check_tensor("table", table, torch.int8, karatsuba.table_shape(params), table.device)
    check_shape(params)
    if not _dispatch(table.device):
        return leaf_panel_plain(table, params)
    panel = torch.empty(panel_shape(params), dtype=torch.int8, device=table.device)
    cmux_k._launch("karatsuba_leaf_panel", load_library().rustfhe_karatsuba_leaf_panel, table,
                   panel, params.N, 2 * params.l)
    return panel


def leaves(digits: torch.Tensor, panel: torch.Tensor, table: torch.Tensor, params: TFHEParams,
           v: Step = Step(), tm: int = TM) -> torch.Tensor:
    """``leaves_plain``'s function on the device of ``digits``: form ``v``'s
    leaf product (one launch for the nine leaves), or nodots' broadcast
    parts."""
    _check_piece_form(v)
    B = digits.shape[0]
    _check_tensor("digits", digits, torch.int8, digit_shape(params, B), digits.device)
    _check_tensor("panel", panel, torch.int8, panel_shape(params), digits.device)
    _check_tensor("table", table, torch.int8, karatsuba.table_shape(params), digits.device)
    check_shape(params)
    _check_tm(params, tm)
    if not _dispatch(digits.device):
        return leaves_plain(digits, panel, table, params, v, tm)
    out = torch.empty(leaf_shape(params, B, v), dtype=torch.int32, device=digits.device)
    cmux_k._launch("karatsuba_leaf_product", load_library().rustfhe_karatsuba_leaf_product,
                   digits, panel, table, out, B, params.N, 2 * params.l, form_code(v), tm)
    return out


def combine(acc: torch.Tensor, leaves_: torch.Tensor, params: TFHEParams,
            v: Step = Step()) -> torch.Tensor:
    """``combine_plain``'s function on the device of ``acc``."""
    _check_piece_form(v)
    B = acc.shape[0]
    _check_tensor("acc", acc, torch.int32, (B, 2 * params.N), acc.device)
    _check_tensor("leaves", leaves_, torch.int32, leaf_shape(params, B, v), acc.device)
    check_shape(params)
    if not _dispatch(acc.device):
        return combine_plain(acc, leaves_, params, v)
    out = torch.empty_like(acc)
    cmux_k._launch("karatsuba_combine", load_library().rustfhe_karatsuba_combine, acc, leaves_,
                   out, B, params.N, params.l, form_code(v))
    return out


def _check_piece_form(v: Step) -> None:
    if v not in FORMS or v.accio:
        raise ValueError(f"the Karatsuba kernels carry no pieces of form {v}")


# --------------------------------------------------------------------- #
# The step and the five probes' wrappers
# --------------------------------------------------------------------- #
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
    """One step of form ``v`` on the card, into the calling thread's digit,
    panel and leaf buffers (``cmux_k._step_buffer``); a~ of sample b is
    ``a_tilde[b * a_stride + a_offset]`` (flat)."""
    if v not in FORMS:
        raise ValueError(f"the Karatsuba kernel carries no form {v}")
    check_shape(params)
    if table.data_ptr() % 4:  # the panel kernel reads the table as words
        table = table.clone()
    B, dev = acc.shape[0], acc.device
    stream = cmux_k._stream(dev)
    out = torch.empty_like(acc)
    if v.accio:
        bufs = (None, None, None)
    else:
        nbytes = 4 * int(torch.Size(leaf_shape(params, B, v)).numel())
        bufs = (cmux_k._step_buffer("kdigits", digit_shape(params, B), dev, stream),
                cmux_k._step_buffer("kpanel", panel_shape(params), dev, stream),
                cmux_k._step_buffer("kleaves", (nbytes,), dev, stream))
    ptrs = [0 if b is None else b.data_ptr() for b in bufs]
    with torch.cuda.device(dev):
        err = load_library().rustfhe_karatsuba_step(
            acc.data_ptr(), a_tilde.data_ptr() + 4 * a_offset, a_stride, table.data_ptr(),
            out.data_ptr(), *ptrs, B, params.N, params.l, params.bgbit, params.decomp_mask,
            form_code(v), tm, stream)
    cmux_k._check(cmux_k.load_library(), err, f"rustfhe_karatsuba_step ({v})")
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
    (2, ...); the result is two steps.  Step 2's digits need every output
    word of step 1 (the rotation mixes all positions), so the card runs the
    two steps one after the other, each its four launches."""
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
    """P2: the step (multiply extract, leaf-first) with the leaf product's
    block tile of 128 samples taken as two sub-tiles of 64: in turn, each
    through the ring by one consumer warpgroup (serial), or by the two
    warpgroups together (grouped: the product's own tile)."""
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
    tree planes built from the residue leaves' by the leaf product's
    producer warpgroup, stage by stage into the swizzled ring just before
    their products (B), or, ``pipelined`` (C), with each stage's key boxes
    requested before its build."""
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
