"""Batched encrypted fixed-width integers: ``FheUint`` / ``FheInt``.

Counterpart of ``rustfhe_tpu/ints.py``.  An encrypted integer is a stack
of TLWE bit ciphertexts, an int32 tensor ``(..., width, n+1)`` on the
context's device, LSB first; every arithmetic op lowers to one standard
cell of ``apps/circuits.py``, evaluated with one batched bootstrap per
level across the integer's bits and all leading batch axes.  Values go in
and out as numpy uint64 (``FheUint``) or int64 (``FheInt``).

Cost notes (bootstraps are the only expensive op):
  * ``~x`` and the comparisons' final negations are linear (``tlwe.neg``:
    the binary encoding is +-1/8, so NOT is negation): free.
  * plaintext shifts and rotations are moves of bit planes: free.
  * ``& | ^`` are one single-level batched bootstrap over all bits.
  * ``+ - * // %`` and comparisons run their cell level-fused.

Every op returns new tensors and writes into none it was given: an
integer's ``bits`` may be shared with another integer (``extend`` and a
zero shift return the operand itself), so no op updates bits in place.

``from_pbs_int`` bridges a PBS-domain integer (``pbs.py``) into the bit
world.  ``encrypt_seeded``/``expand_seeded`` carry an integer's bit planes
as (seed, bodies) (``tlwe.encrypt_torus_seeded``).  Not ported yet: the
public-key constructor (it waits for the public key).
"""

from __future__ import annotations

import numpy as np
import torch

from . import pbs as _pbs
from . import tlwe
from ._u32 import from_numpy
from .apps import circuits


def _select_bits(ctx, cond: torch.Tensor, bits_true: torch.Tensor,
                 bits_false: torch.Tensor) -> torch.Tensor:
    """mux over bit-plane stacks; cond (..., n+1) broadcasts over the
    width axis.  Returns the bits of the true branch where cond = 1."""
    return ctx.mux(cond[..., None, :], bits_false, bits_true)


class FheUint:
    """Encrypted unsigned integer, fixed ``width`` bits, wrapping mod
    2^width; arbitrary leading batch axes.

    ``bits``: int32 tensor ``(..., width, n+1)`` of TLWE ciphertexts, LSB
    first, on ``ctx.device``.
    """

    SIGNED = False

    def __init__(self, ctx, bits: torch.Tensor):
        if not isinstance(bits, torch.Tensor) or bits.dtype != torch.int32 or bits.dim() < 2:
            raise ValueError("bits must be an int32 tensor (..., width, n+1)")
        self.ctx = ctx
        self.bits = bits

    # ------------------------- construction --------------------------- #
    @classmethod
    def encrypt(cls, ctx, values, width: int) -> "FheUint":
        return cls(ctx, ctx.encrypt(cls._to_bits(values, width)))

    @classmethod
    def trivial(cls, ctx, values, width: int) -> "FheUint":
        """Noiseless ciphertexts of plaintext constants: the evaluator-side
        way to mix plaintexts in."""
        return cls(ctx, ctx.trivial(cls._to_bits(values, width)))

    @classmethod
    def encrypt_seeded(cls, ctx, values, width: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Compressed client->server upload of integers: (seed, bodies) over
        the (..., width) bit planes, (n+1)x smaller than ``encrypt``;
        rebuild with ``expand_seeded`` (public: the server or any
        cloud-only context can do it)."""
        return ctx.encrypt_seeded(cls._to_bits(values, width))

    @classmethod
    def expand_seeded(cls, ctx, seeded) -> "FheUint":
        return cls(ctx, ctx.expand_seeded(seeded))

    @classmethod
    def encrypt_public(cls, ctx, pk, values, width: int,
                       gen: torch.Generator | None = None) -> "FheUint":
        """Keyless typed-integer encryption under a PUBLIC key
        (``tlwe.gen_public_key``): works on a cloud-only context with an
        explicit ``gen`` (``TFHE.encrypt_public``)."""
        return cls(ctx, ctx.encrypt_public(pk, cls._to_bits(values, width), gen=gen))

    @staticmethod
    def _to_bits(values, width: int) -> np.ndarray:
        if not 0 < width <= 64:
            raise ValueError(f"width must be in [1, 64], got {width}")
        v = np.asarray(values, np.uint64)
        idx = np.arange(width, dtype=np.uint64)
        return ((v[..., None] >> idx) & np.uint64(1)).astype(np.int32)

    def decrypt(self) -> np.ndarray:
        """Decrypt to integers (np.uint64; np.int64 for FheInt)."""
        bits = self.ctx.decrypt(self.bits).cpu().numpy().astype(np.uint64)
        val = np.zeros(bits.shape[:-1], np.uint64)
        for i in range(self.width):
            val |= bits[..., i] << np.uint64(i)
        if self.SIGNED:
            if self.width == 64:
                # uint64 -> int64 reinterpret is two's complement at w = 64.
                return val.view(np.int64)
            sign = (val >> np.uint64(self.width - 1)) & np.uint64(1)
            return val.astype(np.int64) - (sign.astype(np.int64) << np.int64(self.width))
        return val

    # --------------------------- plumbing ----------------------------- #
    @property
    def width(self) -> int:
        return self.bits.shape[-2]

    @property
    def batch_shape(self) -> torch.Size:
        return self.bits.shape[:-2]

    def _like(self, bits: torch.Tensor) -> "FheUint":
        return type(self)(self.ctx, bits)

    def _zero_plane(self) -> torch.Tensor:
        """A trivial-zero ciphertext plane shaped like one bit plane."""
        return self.ctx.trivial(np.zeros(tuple(self.batch_shape) + (1,), np.int32))

    def _ext_planes(self, k: int) -> torch.Tensor:
        """k extension planes, their own memory: zeros (unsigned) or copies
        of the sign plane (signed; a copied ciphertext decrypts equal, so
        this is a valid sign extension)."""
        plane = self.bits[..., -1:, :] if self.SIGNED else self._zero_plane()
        return plane.expand(self.batch_shape + (k, plane.shape[-1])).contiguous()

    def extend(self, width: int) -> "FheUint":
        """Zero-extend (FheUint) / sign-extend (FheInt) to ``width``."""
        if width == self.width:
            return self
        if width < self.width:
            raise ValueError(f"cannot extend width {self.width} to {width}")
        ext = self._ext_planes(width - self.width)
        return self._like(torch.cat([self.bits, ext], dim=-2))

    def _coerce(self, other, *, dunder: bool = False):
        """Coerce ``other`` to a same-width operand.

        Dunder operators (``dunder=True``) return ``(NotImplemented,
        NotImplemented)`` on unsupported types so that Python can try the
        reflected op; named methods raise ``TypeError``."""
        if isinstance(other, (int, np.integer)):
            # Mask in Python-int space, carry as uint64: widths up to 64
            # coerce exactly.
            val = int(other) & ((1 << self.width) - 1)
            other = type(self).trivial(self.ctx, np.full(tuple(self.batch_shape), val, np.uint64),
                                       self.width)
        if not isinstance(other, FheUint):
            if dunder:
                return NotImplemented, NotImplemented
            raise TypeError(f"operand must be FheUint/FheInt or int, got {type(other).__name__}")
        if other.SIGNED != self.SIGNED:
            raise TypeError("cannot mix FheUint and FheInt operands")
        w = max(self.width, other.width)
        return self.extend(w), other.extend(w)

    def _fixed_width(self):
        return getattr(self.ctx, "circuit_fixed_width", None)

    def _run(self, cell: circuits.Circuit, *operands: "FheUint") -> torch.Tensor:
        """Evaluate a standard cell on the concatenated bit planes; returns
        the output planes ``(..., n_out, n+1)``.  A ``circuit_fixed_width``
        attribute of the context pads every level to that width."""
        ct_in = torch.cat([o.bits for o in operands], dim=-2)
        return circuits.evaluate_encrypted(cell, self.ctx, ct_in, fixed_width=self._fixed_width())

    # ------------------------- arithmetic ----------------------------- #
    def _adder_kind(self) -> str:
        """Adder cell family: "kogge_stone" (default, log depth) or
        "ripple" (fewest gates; ``ctx.circuit_adder = "ripple"``)."""
        return getattr(self.ctx, "circuit_adder", "kogge_stone")

    def add_with_carry(self, other):
        a, b = self._coerce(other)
        cell = (circuits.ripple_carry_adder if self._adder_kind() == "ripple"
                else circuits.kogge_stone_adder)(a.width)
        out = a._run(cell, a, b)
        return a._like(out[..., : a.width, :]), out[..., a.width, :]

    def __add__(self, other):
        a, b = self._coerce(other, dunder=True)
        if a is NotImplemented:
            return NotImplemented
        s, _carry = a.add_with_carry(b)
        return s

    __radd__ = __add__

    def sub_with_borrow(self, other):
        """(self - other mod 2^w, borrow bit ct); borrow = 1 iff self <
        other (unsigned).

        Default path: two's complement through the log-depth adder, a + ~b
        + 1, with ~b and the three output fixups (bit 0's complement,
        borrow = NOT carry) all free plane negations."""
        a, b = self._coerce(other)
        if self._adder_kind() == "ripple":
            out = a._run(circuits.ripple_borrow_subtractor(a.width), a, b)
            return a._like(out[..., : a.width, :]), out[..., a.width, :]
        nb = a._like(tlwe.neg(b.bits))
        out = a._run(circuits.kogge_stone_adder(a.width, incoming_one=True), a, nb)
        diff = torch.cat([tlwe.neg(out[..., :1, :]), out[..., 1: a.width, :]], dim=-2)
        return a._like(diff), tlwe.neg(out[..., a.width, :])

    def __sub__(self, other):
        a, b = self._coerce(other, dunder=True)
        if a is NotImplemented:
            return NotImplemented
        d, _borrow = a.sub_with_borrow(b)
        return d

    def __rsub__(self, other):
        a, b = self._coerce(other, dunder=True)
        if a is NotImplemented:
            return NotImplemented
        return b - a

    def __neg__(self):
        return type(self).trivial(self.ctx, np.zeros(tuple(self.batch_shape), np.uint64),
                                  self.width) - self

    def _mul_cell(self, w: int) -> circuits.Circuit:
        return (circuits.array_multiplier if self._adder_kind() == "ripple"
                else circuits.wallace_multiplier)(w)

    def mul_full(self, other):
        """Full-width unsigned product (2w bits).  FheInt overrides it with
        the sign-extending form."""
        a, b = self._coerce(other)
        return a._like(a._run(a._mul_cell(a.width), a, b))

    def __mul__(self, other):
        # The product mod 2^w has the same bits signed or unsigned.
        a, b = self._coerce(other, dunder=True)
        if a is NotImplemented:
            return NotImplemented
        out = a._run(a._mul_cell(a.width), a, b)
        return a._like(out[..., : a.width, :])

    __rmul__ = __mul__

    def divmod(self, other):
        """Unsigned restoring long division: (quotient, remainder).

        Division by zero gives quotient 2^w - 1 and remainder self (the
        usual TFHE-library convention).  w subtract + select rounds, each
        level-fused; the quotient bits are free NOTs of the borrow bits.
        """
        if self.SIGNED:
            raise TypeError("FheUint.divmod is unsigned; FheInt has its own")
        a, b = self._coerce(other)
        w = a.width
        r = type(a).trivial(a.ctx, np.zeros(tuple(a.batch_shape), np.uint64), w)
        q_planes = [None] * w
        for i in reversed(range(w)):
            # r = (r << 1) | a[i]: a plane shuffle.
            r = a._like(torch.cat([a.bits[..., i: i + 1, :], r.bits[..., : w - 1, :]], dim=-2))
            diff, borrow = r.sub_with_borrow(b)
            r = a._like(_select_bits(a.ctx, borrow, r.bits, diff.bits))
            q_planes[i] = tlwe.neg(borrow)  # q[i] = NOT borrow
        return a._like(torch.stack(q_planes, dim=-2)), r

    def __floordiv__(self, other):
        return self.divmod(other)[0]

    def __mod__(self, other):
        return self.divmod(other)[1]

    # -------------------------- bitwise ------------------------------- #
    def _bitop(self, op: str, other):
        a, b = self._coerce(other, dunder=True)
        if a is NotImplemented:
            return NotImplemented
        return a._like(getattr(a.ctx, op)(a.bits, b.bits))

    def __and__(self, other):
        return self._bitop("and_", other)

    def __or__(self, other):
        return self._bitop("or_", other)

    def __xor__(self, other):
        return self._bitop("xor", other)

    __rand__, __ror__, __rxor__ = __and__, __or__, __xor__

    def __invert__(self):
        return self._like(tlwe.neg(self.bits))

    def __lshift__(self, k: int):
        k = int(k)
        if k < 0:
            raise ValueError(f"negative shift {k}")
        if k == 0:
            return self
        if k >= self.width:
            return type(self).trivial(self.ctx, np.zeros(tuple(self.batch_shape), np.uint64),
                                      self.width)
        z = self._zero_plane().expand(self.batch_shape + (k, self.bits.shape[-1]))
        return self._like(torch.cat([z, self.bits[..., : self.width - k, :]], dim=-2))

    def __rshift__(self, k: int):
        """Logical shift (FheUint) / arithmetic shift (FheInt)."""
        k = int(k)
        if k < 0:
            raise ValueError(f"negative shift {k}")
        if k == 0:
            return self
        k = min(k, self.width)
        if k == self.width:  # unsigned -> zeros; signed -> all sign planes
            return self._like(self._ext_planes(k))
        return self._like(torch.cat([self.bits[..., k:, :], self._ext_planes(k)], dim=-2))

    def rotl(self, k: int) -> "FheUint":
        """Rotate bits left by a plaintext amount: a plane cycle, free."""
        k = int(k) % self.width
        if k == 0:
            return self
        return self._like(torch.cat([self.bits[..., -k:, :], self.bits[..., :-k, :]], dim=-2))

    def rotr(self, k: int) -> "FheUint":
        return self.rotl(-int(k) % self.width)

    # ------------------------- comparisons ---------------------------- #
    def _cmp_bits(self) -> torch.Tensor:
        """Bit planes for magnitude comparison: unsigned uses the raw
        planes; signed flips the sign plane (a free NOT), so that two's
        complement order becomes unsigned order."""
        if not self.SIGNED:
            return self.bits
        return torch.cat([self.bits[..., :-1, :], tlwe.neg(self.bits[..., -1:, :])], dim=-2)

    def _compare(self, other):
        """(lt, eq, gt) encrypted bit ciphertexts.

        Default path: the log-depth prefix comparator (b's planes
        pre-complemented for free); lt = NOT ge is free, gt = ge AND NOT eq
        is one extra single-gate level."""
        a, b = self._coerce(other)
        fw = a._fixed_width()
        if self._adder_kind() == "ripple":
            ct_in = torch.cat([a._cmp_bits(), b._cmp_bits()], dim=-2)
            out = circuits.evaluate_encrypted(circuits.comparator(a.width), a.ctx, ct_in,
                                              fixed_width=fw)
            return out[..., 0, :], out[..., 1, :], out[..., 2, :]
        ct_in = torch.cat([a._cmp_bits(), tlwe.neg(b._cmp_bits())], dim=-2)
        out = circuits.evaluate_encrypted(circuits.prefix_comparator(a.width), a.ctx, ct_in,
                                          fixed_width=fw)
        ge, eq = out[..., 0, :], out[..., 1, :]
        return tlwe.neg(ge), eq, a.ctx.and_(ge, tlwe.neg(eq))

    def lt(self, other):
        return self._compare(other)[0]

    def eq(self, other):
        return self._compare(other)[1]

    def gt(self, other):
        return self._compare(other)[2]

    def ne(self, other):
        return tlwe.neg(self.eq(other))

    def le(self, other):
        return tlwe.neg(self.gt(other))

    def ge(self, other):
        return tlwe.neg(self.lt(other))

    # -------------------------- selection ----------------------------- #
    def select(self, cond: torch.Tensor, other) -> "FheUint":
        """cond ? self : other, cond an encrypted bit ``(..., n+1)``."""
        a, b = self._coerce(other)
        return a._like(_select_bits(a.ctx, cond, a.bits, b.bits))

    def min_(self, other):
        a, b = self._coerce(other)
        return a.select(a.lt(b), b)

    def max_(self, other):
        a, b = self._coerce(other)
        return a.select(a.gt(b), b)

    def abs_(self):
        if not self.SIGNED:
            return self
        # The sign plane is an encrypted is-negative bit.
        return (-self).select(self.bits[..., -1, :], self)


class FheInt(FheUint):
    """Encrypted signed integer (two's complement, ``width`` bits).

    Wrapping add/sub/mul and the bitwise/shift/select ops are inherited
    bit-identically; comparisons order by the flipped sign plane and ``>>``
    is arithmetic.
    """

    SIGNED = True

    def mul_full(self, other):
        """Full-width signed product (2w bits, two's complement): both
        operands sign-extended to 2w, the low 2w bits of the unsigned
        product, which are the exact signed product."""
        a, b = self._coerce(other)
        w = a.width
        ae, be = a.extend(2 * w), b.extend(2 * w)
        out = ae._run(a._mul_cell(2 * w), ae, be)
        return a._like(out[..., : 2 * w, :])

    def divmod(self, other):
        """Signed truncated division (C/Rust): the quotient rounds toward
        zero, the remainder takes the dividend's sign.  The unsigned
        restoring divider runs on |a|, |b|, and the signs come back through
        encrypted selects; |INT_MIN| wraps, as ``wrapping_div`` does."""
        a, b = self._coerce(other)
        sa = a.bits[..., -1, :]  # the sign planes are encrypted is-negative bits
        sb = b.bits[..., -1, :]
        ua = FheUint(a.ctx, (-a).select(sa, a).bits)
        ub = FheUint(b.ctx, (-b).select(sb, b).bits)
        q_u, r_u = ua.divmod(ub)
        q_u, r_u = a._like(q_u.bits), a._like(r_u.bits)
        sdiff = a.ctx.xor(sa, sb)
        return (-q_u).select(sdiff, q_u), (-r_u).select(sa, r_u)

    @staticmethod
    def _to_bits(values, width: int) -> np.ndarray:
        v = np.asarray(values)
        if np.issubdtype(v.dtype, np.signedinteger):
            # int64 -> uint64 reinterpret, then mask: exact up to width 64.
            mask = (1 << width) - 1 if 0 < width <= 64 else 0
            v = v.astype(np.int64).view(np.uint64) & np.uint64(mask)
        return FheUint._to_bits(v, width)


def from_pbs_int(ctx, ct: torch.Tensor, space: int, *, unsafe: bool = False) -> FheUint:
    """Bridge a PBS-domain encrypted integer into the bit world: decompose
    ``ct`` (padding-bit encoding of x in [0, space), ``pbs.py``) into a
    ``FheUint`` of width log2(space) via multi-output PBS with raw
    gate-encoded +-mu tables.

    The multi-output degree ``t`` is chosen adaptively: the largest power
    of two whose t^2-scaled modulus-switch drift passes the calibrated
    noise check at ``ctx.params`` (``pbs.check_pbs_many``; t=1 uses
    ``check_pbs_space``), and the bit planes split into ``ceil(width / t)``
    rotations: at ``params.PBS_PARAMS`` a space-8 integer decomposes in 2
    rotations of t=2 at a >= 5-sigma margin, where one rotation of t=4
    would sit at ~2.6 calibrated sigma.  If even t=1 fails the space
    check, raises unless ``unsafe=True`` (which also takes the
    single-rotation maximal t, for borderline-margin measurements).

    The result's bits are fresh gate-encoded ciphertexts, so the integer
    and circuit API composes on them.  ``ct`` is not written to.
    """
    w = space.bit_length() - 1
    if space != 1 << w:
        raise ValueError(f"space must be a power of two, got {space}")
    t_full = 1 << max(0, (w - 1)).bit_length() if w > 1 else 1  # pad to pow2
    if unsafe:
        t = t_full
    else:
        t = 0
        cand = t_full
        while cand >= 1:
            ok, msg = (_pbs.check_pbs_many(ctx.params, space, cand)
                       if cand > 1 else _pbs.check_pbs_space(ctx.params, space))
            if ok:
                t = cand
                break
            cand >>= 1
        if t == 0:
            raise ValueError(
                f"from_pbs_int margin below threshold at this parameter set "
                f"even at t=1 ({msg}); use a PBS-tuned preset "
                f"(params.PBS_PARAMS) or pass unsafe=True to override"
            )
    mu = ctx.params.mu
    neg_mu = (-mu) & 0xFFFFFFFF
    bit_tab = [[(mu if (x >> j) & 1 else neg_mu) for x in range(space)]
               for j in range(w)]
    planes = []
    for j0 in range(0, w, t):
        chunk = bit_tab[j0: j0 + t]
        pad = t - len(chunk)
        tabs = from_numpy(np.array(chunk + [[0] * space] * pad, np.uint32), ct.device)
        if t == 1:
            out = _pbs.pbs(ctx.ck, ct, tabs[0], space=space, raw=True, params=ctx.params,
                           unsafe=unsafe)[..., None, :]
        else:
            out = _pbs.pbs_many(ctx.ck, ct, tabs, space=space, raw=True, params=ctx.params,
                                unsafe=unsafe)
        planes.append(out[..., : len(chunk), :])
    return FheUint(ctx, torch.cat(planes, dim=-2))
