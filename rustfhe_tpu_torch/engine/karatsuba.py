"""The residue layout and the two-level Karatsuba CMux step, in plain torch.

Counterpart of the Karatsuba pieces of ``rustfhe_tpu/engine/pallas_k.py``
(the JAX engine ``"pallas_k2"``), the port's own copy:

  a(X) = ae(Y) + X ao(Y),  Y = X^2:
  (a (*) q)_e = ae (*) qe + Y * (ao (*) qo)
  (a (*) q)_o = (ae + ao) (*) (qe + qo) - ae (*) qe - ao (*) qo

applied ``LEVELS`` = 2 times: the negacyclic product of size N becomes
T = 9 products of size ns = N / 4 (the "leaves"), 0.5625x the
multiply-adds.  The accumulator lives in the residue layout, one (B, 2N)
plane of R = 4 segments per polynomial half, ``[p0r0 .. p0r3 | p1r0 ..
p1r3]``: segment (p, r) holds the coefficients i = 4m + r of half p
(``scan_enter`` / ``scan_exit``).

* ``tree_planes`` / ``tree_combine`` (pallas_k.py:65, :78): the operand
  tree of residues and its inverse over the leaf products;
* ``rotate_res`` (``_rotate_res_inkernel``, pallas_k.py:145, with
  ``_mul_xpow_res`` :127 and ``_roll_y_static_seg`` :108): X^a in the
  residue layout;
* ``prepare_table``: the leaf limb table of ``PallasKaratsubaEngine.
  prepare_trgsw`` at levels 2 (pallas_k.py:575), in the port's layout;
  ``table_from_qd`` maps the JAX layout (random bytes too) into it;
* ``step_plain``: the plain Karatsuba step, with every measurement
  variant of the probes that time it (``engine/karatsuba_probe.py``),
  in the leaf-first recombination order (``_karatsuba_accumulate``,
  pallas_k.py:172) or the limb-outer one
  (``benches/vpu_reduce_probe.py:120``, ``benches/karatsuba2_probe.py:142``);
  where the tree planes are built does not change the function.

Torus words are int32 tensors with wrapping arithmetic (``_u32``).  The
leaf products are float64 circulant products, exact: every sum is at most
2L * ns * 128 * 128 < 2^25 (``check_bound``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .._u32 import s32, srl, wrap
from ..params import TFHEParams
from ..poly import to_signed_limbs
from .plain import LIMB_BITS, NUM_LIMBS, _circulant_product

LEVELS = 2
R = 1 << LEVELS  # residues per polynomial half
T = 3 ** LEVELS  # leaves


# --------------------------------------------------------------------- #
# The Karatsuba tree
# --------------------------------------------------------------------- #
def tree_planes(res: list, add) -> list:
    """2^L residue planes -> 3^L combination planes: planes(x) =
    planes(x_even) ++ planes(x_odd) ++ planes(x_even + x_odd), the leaf
    order of the key table and of the kernels."""
    if len(res) == 1:
        return [res[0]]
    e, o = res[0::2], res[1::2]
    s = [add(a, b) for a, b in zip(e, o)]
    return tree_planes(e, add) + tree_planes(o, add) + tree_planes(s, add)


def tree_combine(ms: list, shiftz1) -> list:
    """3^L leaf products -> 2^L residue outputs, the inverse of
    ``tree_planes``: result_e = E + Y*O, result_o = S - E - O, residues
    interleaved; Y times a residue list is a barrel shift whose wrapped
    element gets ``shiftz1`` (the negacyclic shift by one at leaf size)."""
    if len(ms) == 1:
        return [ms[0]]
    third = len(ms) // 3
    E = tree_combine(ms[:third], shiftz1)
    O = tree_combine(ms[third: 2 * third], shiftz1)
    S = tree_combine(ms[2 * third:], shiftz1)
    k = len(E)
    yo = [shiftz1(O[-1])] + O[: k - 1]
    res_e = [a + b for a, b in zip(E, yo)]
    res_o = [s - a - b for s, a, b in zip(S, E, O)]
    out = []
    for i in range(k):
        out += [res_e[i], res_o[i]]
    return out


def shiftz1(m: torch.Tensor) -> torch.Tensor:
    """Z * m for Z = X^R at leaf size ns (last axis): a negacyclic shift by
    one (``_shiftz1_u32`` / ``_shiftz1_i32``, pallas_k.py:164-169)."""
    return torch.cat([-m[..., -1:], m[..., :-1]], dim=-1)


# --------------------------------------------------------------------- #
# The residue layout
# --------------------------------------------------------------------- #
def scan_enter(acc: torch.Tensor) -> torch.Tensor:
    """(..., 2, N) -> (..., 2N) residue layout [p0r0 .. p1r3]."""
    N = acc.shape[-1]
    eo = acc.reshape(acc.shape[:-1] + (N // R, R)).movedim(-1, -2)
    return eo.reshape(acc.shape[:-2] + (2 * N,)).contiguous()


def scan_exit(flat: torch.Tensor) -> torch.Tensor:
    """Inverse of ``scan_enter``: (..., 2N) -> (..., 2, N)."""
    N = flat.shape[-1] // 2
    eo = flat.reshape(flat.shape[:-1] + (2, R, N // R)).movedim(-2, -1)
    return eo.reshape(flat.shape[:-1] + (2, N)).contiguous()


def roll_y_static_seg(x: torch.Tensor, s: int, nh: int, nseg: int) -> torch.Tensor:
    """Every segment of ``x`` (B, nseg*nh) times Z^s (static s) under
    Z^nh = -1."""
    s %= 2 * nh
    neg = s >= nh
    if neg:
        s -= nh
    out = x
    if s:
        parts = []
        for g in range(nseg):
            seg = x[:, g * nh: (g + 1) * nh]
            parts += [-seg[:, nh - s:], seg[:, : nh - s]]
        out = torch.cat(parts, dim=1)
    return -out if neg else out


def mul_xpow_res(x: torch.Tensor, ns: int, sh: int) -> torch.Tensor:
    """X^sh (0 < sh < R) in the residue layout: new residue i is residue
    i - sh; a wrapped residue gets one Z factor."""
    parts = []
    for p in range(2):
        r = [x[:, (R * p + i) * ns: (R * p + i + 1) * ns] for i in range(R)]
        for i in range(R):
            parts.append(r[i - sh] if i >= sh else shiftz1(r[R + i - sh]))
    return torch.cat(parts, dim=1)


def rotate_res(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """X^n * x for x (B, 2N) in the residue layout and n (B,) in [0, 2N):
    the low ``LEVELS`` bits of n barrel-shift the residues, the others
    rotate all 2R segments by Z^t, one select per bit."""
    ns = x.shape[-1] // (2 * R)
    n = n.to(torch.int64)[:, None]
    out = x
    for b in range(LEVELS):
        out = torch.where(((n >> b) & 1) == 1, mul_xpow_res(out, ns, 1 << b), out)
    for k in range((2 * ns - 1).bit_length()):
        out = torch.where(((n >> (k + LEVELS)) & 1) == 1,
                          roll_y_static_seg(out, 1 << k, ns, 2 * R), out)
    return out


# --------------------------------------------------------------------- #
# The leaf limb table
# --------------------------------------------------------------------- #
def table_shape(params: TFHEParams) -> tuple:
    """(2, T, K, 2L, 2ns): per output half c, leaf t and limb k, the 2L
    doubled planes of the key rows' tree planes."""
    return (2, T, NUM_LIMBS, 2 * params.l, params.N // 2)


def prepare_table(rows: torch.Tensor) -> torch.Tensor:
    """TRGSW rows ``(2L, 2, N)`` int32 -> the leaf limb table int8
    ``(2, T, K, 2L, 2ns)``.  Plane [c, t, k, j] is ``[limbs(-q), limbs(q)]``
    of limb k of q = leaf t of ``tree_planes`` over the residues of row
    (j, c), so out[x] = sum_i d[i] * plane[x - i + ns] is the negacyclic
    product at size ns (the layout of ``plain.prepare_trgsw_limbs``).  The
    key's tree sums wrap mod 2^32 before the limb split: the product is
    taken mod 2^32, so the wrapped sum recombines exactly."""
    res = [rows[..., i::R] for i in range(R)]
    q = torch.stack(tree_planes(res, lambda a, b: a + b), dim=-2)  # (2L, 2, T, ns)
    neg = to_signed_limbs(-q, LIMB_BITS, NUM_LIMBS).movedim(-1, -2)  # (2L, 2, T, K, ns)
    pos = to_signed_limbs(q, LIMB_BITS, NUM_LIMBS).movedim(-1, -2)
    return torch.cat([neg, pos], dim=-1).permute(1, 2, 3, 0, 4).contiguous()


def table_from_qd(qd: torch.Tensor) -> torch.Tensor:
    """The JAX package's leaf table ``qd`` int8 ``(2, 2L*K*T, 2ns)``
    (``PallasKaratsubaEngine.prepare_trgsw`` at levels 2: row
    g = (j*K + k)*T + t of half c holds ``[limbs(q), limbs(-q)]``) -> the
    port's ``(2, T, K, 2L, 2ns)``, halves swapped.  It moves bytes and
    assumes nothing of them, so it also carries random bytes."""
    if (qd.dtype != torch.int8 or qd.dim() != 3 or qd.shape[0] != 2
            or qd.shape[1] % (NUM_LIMBS * T)):
        raise ValueError(f"qd must be int8 (2, 2L*{NUM_LIMBS}*{T}, 2ns), got {qd.dtype} "
                         f"{tuple(qd.shape)}")
    _, rows, tn = qd.shape
    ns = tn // 2
    t = qd.reshape(2, rows // (NUM_LIMBS * T), NUM_LIMBS, T, tn).permute(0, 3, 2, 1, 4)
    return torch.cat([t[..., ns:], t[..., :ns]], dim=-1).contiguous()


def check_bound(params: TFHEParams) -> None:
    """Raise unless the digit tree sums fit int8 (half_bg * 2^LEVELS <=
    128, as pallas_k.py:579 asserts) and every (leaf, limb) sum,
    2L * ns * 128 * 128 at most, stays below 2^31."""
    if params.half_bg << LEVELS > 128:
        raise ValueError(f"digit tree sums reach half_bg * {R} = {params.half_bg * R} > 128 "
                         f"at bgbit={params.bgbit}: outside int8")
    bound = 2 * params.l * (params.N // R) * 128 * 128
    if bound >= 1 << 31:
        raise ValueError(f"(leaf, limb) sums reach 2L*ns*128*128 = {bound} >= 2^31 at "
                         f"N={params.N}, l={params.l}: outside int32")


# --------------------------------------------------------------------- #
# The plain step and its measurement variants
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class Step:
    """One form of the Karatsuba step.  The defaults are the production
    step (K1 at levels 2, ``_kernel_step_k``); each field changes one part:

    rot      "rotate"; "norot": diff = a~ as a word; "skip": diff = 1
    extract  the digit of level lv: "sar" (shift up, arithmetic shift
             down), "mul" (window, + (raw & half) * 0xFFFFFFFE), "shift"
             (window, - (raw & half) << 1): the same digits; "top": every
             level gets the top digit
    planes   the digit tree's sums: 32 (int32), 16 (packed), 0 (none:
             every plane is residue 0)
    dots     False: no products; per (leaf, limb) part = sum_j sum_mb
             d_j[mb*tm] + plane_j[n - mb*tm + ns], the broadcast add of
             the TPU probe
    limbs    4, or 1 (limb 0 only, no recombination)
    leaf_first  recombine the limbs per leaf, then one combine; else one
             combine per limb, then the limbs (limb-outer)
    combine  False: output residue i is leaf i
    split    "" (the block's tile at once), "serial" or "grouped": the
             tile as two sub-tiles (the same function)
    build    where the tree planes are built (the same function):
             "upfront" (all before the products), "leaf" (each leaf's
             just before its products) or "pipelined" (a leaf's second
             plane group between its first group's products)
    accio    out = acc + 1
    """

    rot: str = "rotate"
    extract: str = "sar"
    planes: int = 32
    dots: bool = True
    limbs: int = NUM_LIMBS
    leaf_first: bool = True
    combine: bool = True
    split: str = ""
    build: str = "upfront"
    accio: bool = False

    @property
    def exact(self) -> bool:
        """True when the form computes the step's function."""
        return (self.rot == "rotate" and self.extract != "top" and self.planes != 0
                and self.dots and self.limbs == NUM_LIMBS and self.combine
                and not self.accio)


def step_digits(acc: torch.Tensor, a_tilde: torch.Tensor, params: TFHEParams,
                v: Step) -> torch.Tensor:
    """The digit tree of a step: int64 (B, T, 2L, ns), plane j = p*l + lv."""
    B, tn = acc.shape
    ns = tn // (2 * R)
    if v.rot == "rotate":
        diff = rotate_res(acc, a_tilde) - acc
    elif v.rot == "norot":
        diff = a_tilde[:, None].expand(B, tn)
    else:
        diff = torch.ones_like(acc)
    m = s32(params.decomp_mask)
    u = (diff + m) ^ m
    bits, half = params.bgbit, params.half_bg
    levels = [0] * params.l if v.extract == "top" else range(params.l)
    raw = [srl(u, 32 - bits * (lv + 1)) & (params.bg - 1) for lv in levels]
    d = torch.stack([r - 2 * (r & half) for r in raw], dim=1).to(torch.int64)  # (B, l, 2N)
    d = d.reshape(B, params.l, 2, R, ns).transpose(1, 2).reshape(B, 2 * params.l, R, ns)
    res = [d[:, :, r] for r in range(R)]
    planes = [res[0]] * T if v.planes == 0 else tree_planes(res, lambda a, b: a + b)
    return torch.stack(planes, dim=1)


def leaf_parts(dig: torch.Tensor, table: torch.Tensor, v: Step, tm: int) -> torch.Tensor:
    """int64 (B, T, 2, K, ns): per leaf t, half c and limb k the sum over
    the 2L planes of the leaf's negacyclic product (exact in float64)."""
    B, _, two_l, ns = dig.shape
    K = table.shape[2]
    if not v.dots:
        d = dig[..., ::tm].sum(dim=(2, 3))  # (B, T)
        n = torch.arange(ns, device=table.device)
        i = torch.arange(0, ns, tm, device=table.device)
        w = table[..., n[None, :] - i[:, None] + ns].to(torch.int64).sum(dim=(3, 4))  # (2, T, K, ns)
        return d[:, :, None, None, None] + w.transpose(0, 1)[None]
    # leaf t's planes as (2L, 2*K, 2ns): one circulant of the (c, k) outputs
    planes = table.permute(1, 3, 0, 2, 4).reshape(T, two_l, 2 * K, 2 * ns)  # (t, j, (c, k), x)
    parts = [_circulant_product(dig[:, t], planes[t]) for t in range(T)]
    return torch.stack(parts, dim=1).to(torch.int64).reshape(B, T, 2, K, ns)


def combine_parts(acc: torch.Tensor, part: torch.Tensor, v: Step) -> torch.Tensor:
    """acc plus the step's output from its (leaf, limb) parts ``part`` int64
    (B, T, 2, K', ns), K' >= ``v.limbs``: the limbs recombine per leaf,
    then one tree combine (leaf-first), or one combine per limb, then the
    limbs (limb-outer), or output residue i is leaf i (no combine)."""
    part = part[:, :, :, : v.limbs]
    shifts = [LIMB_BITS * k for k in range(v.limbs)]
    if not v.combine:
        outs = [sum(part[:, i, :, k] << sh for k, sh in enumerate(shifts)) for i in range(R)]
    elif v.leaf_first:
        leaves = [sum(part[:, t, :, k] << sh for k, sh in enumerate(shifts)) for t in range(T)]
        outs = tree_combine(leaves, shiftz1)
    else:
        outs = [0] * R
        for k, sh in enumerate(shifts):
            res = tree_combine([part[:, t, :, k] for t in range(T)], shiftz1)
            outs = [o + (r << sh) for o, r in zip(outs, res)]
    flat = torch.stack(outs, dim=2).reshape(acc.shape)  # (B, c, i, ns) -> (B, 2N)
    return wrap(acc.to(torch.int64) + flat)


def step_plain(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
               params: TFHEParams, v: Step = Step(), tm: int = 128) -> torch.Tensor:
    """The Karatsuba step ``v`` in the residue layout: ``acc`` int32
    (B, 2N), ``a_tilde`` int32 (B,) in [0, 2N), ``table`` int8 (2, T, K,
    2L, 2ns) (``prepare_table``).  The production form is acc +
    ExtProd(key, Decompose(X^{a~} * acc - acc)) in the residue layout."""
    if v.accio:
        return acc + 1
    part = leaf_parts(step_digits(acc, a_tilde, params, v), table, v, tm)
    return combine_parts(acc, part, v)
