"""Radix-PBS encrypted integers: block arithmetic on programmable bootstraps.

Counterpart of ``rustfhe_tpu/radix.py``, held to it word for word
(``tests/test_torch_radix.py``).  The bit-circuit integers (``ints.py``)
cost one bootstrap level per gate level: an 8-bit ripple add is 15
sequential levels.  Here an integer is a little-endian vector of 2-bit
digits, each digit a PBS-domain ciphertext (``pbs.py``'s padding-bit
encoding at space 8: message 2 bits plus carry headroom), and arithmetic
works digit-wise:

  * add/sub: per digit, ``a_i + b_i + carry`` is a linear torus add
    (values <= 7 fit space 8), and one batched PBS level extracts
    ``(sum & 3, sum >> 2)``, message and carry.  An 8-bit add is 4
    bootstrap levels (8 lookups).
  * comparisons: per-digit difference lookups emit gate-encoded bits (raw
    +-mu tables), combined by the gates.
  * plaintext shifts re-index digits: even amounts are free, odd amounts
    cost one PBS level whose two outputs per digit recombine linearly.
  * overflow flags: the unsigned carry-out re-encoded as a gate bit
    (``add_overflows``); signed overflow from the three sign bits
    (``RadixInt.add_with_overflow``).
  * a plaintext multiplier folds its bits into shifts (``_mul_scalar``:
    one shared odd-shift level and a popcount-deep add tree; x10 on 8
    bits is 5 levels against the general multiply's 18; the JAX
    docstring's "9" miscounts its own formula).
  * signed full-width multiply by ``a*b = a_u*b_u - 2^w(sa*b_u + sb*a_u)
    mod 2^{2w}`` (``RadixInt.mul(full=True)``; nd=4: 52 levels).
  * radix <-> bit bridges (one PBS level each way), through which
    division, bitwise ops and the encrypted select run.
  * ``RadixInt``: the signed (two's complement) variant.

Every level is one call of ``pbs.pbs`` (or ``pbs_many``) with the lanes
stacked on a leading axis and a table per lane: a test vector per row,
flattened with the rows by ``bootstrap.blind_rotate``, so a level is one
blind rotation of K1 per step (one launch of K3 on a latency key at up
to ``rotate_all_k.MAX_BATCH`` rows).

Soundness is checked with the calibrated noise model (``check_radix``,
``utils/noise.py``): at ``params.PBS_PARAMS`` the add path's worst PBS
input (three bootstrap outputs summed, then the modulus switch) has a
13.8-sigma calibrated lower-bound margin, and DEFAULT_PARAMS is rejected.
``use_many=True`` extracts (msg, carry) with one PBSmanyLUT rotation
(t=2) at a 7.9-sigma lower bound at PBS_PARAMS.

No op writes into a tensor it was given: every result is a new tensor
(torch's in-place ops would change an operand that JAX's arrays never
change).  ``encrypt_seeded``/``expand_seeded`` carry the digit
ciphertexts as (seed, bodies); ``encrypt_seeded`` raises ValueError on a
context without a secret key, where the JAX package's has no guard of its
own (ROADMAP Queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import pbs as _pbs
from . import tlwe
from ._u32 import from_numpy
from .ints import FheInt, FheUint

MSG_BITS = 2
MSG_MOD = 1 << MSG_BITS          # digit values live in [0, 4)
SPACE = 1 << (MSG_BITS + 1)      # PBS space: one carry bit of headroom


def check_radix(params, use_many: bool = False,
                min_sigmas: float = 5.0) -> tuple[bool, str]:
    """Noise verdict for the radix add path at ``params``.

    The worst PBS input of one add level is ``a_i + b_i + carry``: three
    fresh bootstrap outputs summed (each carrying blind-rotate + key-switch
    variance), then the modulus switch (t^2-scaled when ``use_many``).
    Margin = the space-8 half-bucket over the calibrated sigma (stated as
    the preset-calibrated lower bound, utils/noise.calibrate)."""
    from .utils.noise import calibrate, noise_budget

    nb = noise_budget(params)
    var_out = nb.var_bootstrap + nb.var_keyswitch  # one bootstrap output
    t2 = 4.0 if use_many else 1.0
    var = 3.0 * var_out + t2 * nb.var_rounding
    cm = calibrate(params, math.sqrt(var), 1.0 / (4.0 * SPACE))
    msg = (f"radix add (space={SPACE}, use_many={use_many}): "
           f"{cm.describe()}")
    return cm.lower_bound_sigmas >= min_sigmas, msg


def check_radix_mul(params, min_sigmas: float = 5.0) -> tuple[bool, str]:
    """Noise verdict for the radix multiply path at ``params``.

    The multiply's worst PBS input is the bivariate product index
    ``a_i + 4 * b_bit``: one bootstrap output plus a 4-scaled bootstrap
    output (variance x16) plus the modulus switch."""
    from .utils.noise import calibrate, noise_budget

    nb = noise_budget(params)
    var_out = nb.var_bootstrap + nb.var_keyswitch
    var = 17.0 * var_out + nb.var_rounding
    cm = calibrate(params, math.sqrt(var), 1.0 / (4.0 * SPACE))
    msg = f"radix mul (space={SPACE}, idx = a + 4*bit): {cm.describe()}"
    return cm.lower_bound_sigmas >= min_sigmas, msg


def _digit_tables(kind: str) -> np.ndarray:
    """(space,) int tables for the digit-normalization lookups."""
    x = np.arange(SPACE, dtype=np.uint32)
    if kind == "msg":
        return x & (MSG_MOD - 1)
    if kind == "carry":
        return x >> MSG_BITS
    raise ValueError(kind)


def _gate_tables(ctx, *conds) -> np.ndarray:
    """Raw (k, space) tables emitting the gate encoding: +mu where a
    condition holds, -mu elsewhere (uint32 words)."""
    mu, neg_mu = ctx.params.mu, (-ctx.params.mu) & 0xFFFFFFFF
    return np.stack([np.where(c, mu, neg_mu) for c in conds]).astype(np.uint32)


class RadixUint:
    """Encrypted unsigned integer, ``2 * ndigits`` bits, wrapping.

    ``digits``: int32 ``(..., ndigits, n+1)`` PBS-domain ciphertexts on
    ``ctx.device``, least-significant digit first; each encrypts a value
    in [0, 4) at space 8.  Arbitrary leading batch axes.  Numpy uint32
    words are taken too (copied onto the device).
    """

    def __init__(self, ctx, digits):
        if not isinstance(digits, torch.Tensor):
            digits = from_numpy(digits, ctx.device)
        if digits.dtype != torch.int32 or digits.dim() < 2:
            raise ValueError("digits must be an int32 tensor (..., ndigits, n+1)")
        self.ctx = ctx
        self.digits = digits

    # ------------------------- construction --------------------------- #
    @staticmethod
    def _to_digits(values, ndigits: int) -> np.ndarray:
        v = np.asarray(values, np.uint64)
        idx = np.arange(ndigits, dtype=np.uint64) * np.uint64(MSG_BITS)
        return ((v[..., None] >> idx) & np.uint64(MSG_MOD - 1)).astype(np.uint32)

    @classmethod
    def encrypt(cls, ctx, values, ndigits: int) -> "RadixUint":
        if ctx.sk is None or ctx.gen is None:
            raise ValueError("cloud-only context cannot encrypt")
        digs = cls._to_digits(values, ndigits)
        return cls(ctx, _pbs.encrypt_int(ctx.gen, ctx.sk.lv0, digs, SPACE, ctx.params))

    @classmethod
    def trivial(cls, ctx, values, ndigits: int) -> "RadixUint":
        digs = cls._to_digits(values, ndigits)
        return cls(ctx, tlwe.trivial(_pbs.encode_int(digs, SPACE).to(ctx.device),
                                     ctx.params.n))

    @classmethod
    def encrypt_seeded(cls, ctx, values, ndigits: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Compressed upload of radix integers: (seed, bodies) over the
        (..., ndigits) digit ciphertexts, (n+1)x smaller than ``encrypt``;
        rebuild with ``expand_seeded`` (public)."""
        if ctx.sk is None or ctx.gen is None:
            raise ValueError("cloud-only context cannot encrypt")
        digs = cls._to_digits(values, ndigits)
        return tlwe.encrypt_torus_seeded(ctx.gen, ctx.sk.lv0,
                                         _pbs.encode_int(digs, SPACE).to(ctx.device), ctx.params)

    @classmethod
    def expand_seeded(cls, ctx, seeded) -> "RadixUint":
        return cls(ctx, ctx.expand_seeded(seeded))

    def decrypt(self) -> np.ndarray:
        if self.ctx.sk is None:
            raise ValueError("cloud-only context cannot decrypt")
        digs = _pbs.decrypt_int(self.digits, self.ctx.sk.lv0, SPACE).cpu().numpy()
        digs = digs.astype(np.uint64)
        val = np.zeros(digs.shape[:-1], np.uint64)
        for i in range(self.ndigits):
            val |= (digs[..., i] % MSG_MOD) << np.uint64(MSG_BITS * i)
        return val

    # --------------------------- plumbing ----------------------------- #
    @property
    def ndigits(self) -> int:
        return self.digits.shape[-2]

    @property
    def width(self) -> int:
        return MSG_BITS * self.ndigits

    @property
    def batch_shape(self) -> torch.Size:
        return self.digits.shape[:-2]

    def _like(self, digits) -> "RadixUint":
        return RadixUint(self.ctx, digits)

    def _coerce(self, other) -> tuple["RadixUint", "RadixUint"]:
        if isinstance(other, (int, np.integer)):
            val = int(other) & ((1 << self.width) - 1)
            other = type(self).trivial(
                self.ctx, np.full(tuple(self.batch_shape), val, np.uint64), self.ndigits)
        if not isinstance(other, RadixUint):
            raise TypeError(
                f"operand must be RadixUint or int, got {type(other).__name__}")
        if isinstance(self, RadixInt) != isinstance(other, RadixInt):
            raise TypeError("cannot mix RadixUint and RadixInt operands")
        if other.ndigits != self.ndigits:
            raise ValueError(
                f"digit-count mismatch: {self.ndigits} vs {other.ndigits}")
        return self, other

    # ----------------------- the PBS level core ----------------------- #
    def _pbs_level(self, cts: torch.Tensor, tables, raw: bool = False,
                   unsafe: bool = False) -> torch.Tensor:
        """One batched PBS level: ``cts`` (k, ..., n+1) with per-lane
        ``tables`` (k, space) (numpy uint32) -> (k, ..., n+1).  All k
        lookups run in one bootstrap (the lane axis is just batch), with a
        test vector per row."""
        ctx = self.ctx
        lead = tuple(cts.shape[1:-1])
        tabs = torch.from_numpy(np.asarray(tables, np.uint32).astype(np.int64))
        tabs = tabs.reshape((cts.shape[0],) + (1,) * len(lead) + (SPACE,))
        tabs = tabs.expand((cts.shape[0],) + lead + (SPACE,))
        return _pbs.pbs(ctx.ck, cts, tabs, space=SPACE, params=ctx.params, raw=raw,
                        unsafe=unsafe)

    def _extract_msg_carry(self, s: torch.Tensor, use_many: bool, unsafe: bool = False):
        """(msg, carry) of a space-8 sum ciphertext ``s`` (..., n+1), one
        bootstrap level."""
        tm, tc = _digit_tables("msg"), _digit_tables("carry")
        if use_many:
            lead = tuple(s.shape[:-1])
            tabs = torch.from_numpy(np.stack([tm, tc]).astype(np.int64))  # (2, space)
            tabs = tabs.reshape((1,) * len(lead) + (2, SPACE)).expand(lead + (2, SPACE))
            out = _pbs.pbs_many(self.ctx.ck, s, tabs, space=SPACE, params=self.ctx.params,
                                unsafe=unsafe)
            return out[..., 0, :], out[..., 1, :]
        both = self._pbs_level(torch.stack([s, s]), np.stack([tm, tc]), unsafe=unsafe)
        return both[0], both[1]

    # ------------------------- arithmetic ----------------------------- #
    def _check_add(self, use_many: bool, unsafe: bool) -> None:
        ok, msg = check_radix(self.ctx.params, use_many=use_many)
        if not ok and not unsafe:
            raise ValueError(
                f"radix arithmetic margin below threshold ({msg}); use "
                f"params.PBS_PARAMS or pass unsafe=True")

    def add_with_carry(self, other, *, use_many: bool = False,
                       unsafe: bool = False):
        """(self + other mod 2^width, carry-out ciphertext).

        ``ndigits`` sequential bootstrap levels (the carry chain is the
        only data dependence); each level is one batched PBS extracting
        (msg, carry) of the linear digit sum.  The carry-out is a
        PBS-domain bit (value in {0,1} at space=8)."""
        a, b = self._coerce(other)
        a._check_add(use_many, unsafe)
        carry = None
        out = []
        for i in range(a.ndigits):
            s = a.digits[..., i, :] + b.digits[..., i, :]
            if carry is not None:
                s = s + carry
            m, carry = a._extract_msg_carry(s, use_many, unsafe)
            out.append(m)
        return a._like(torch.stack(out, dim=-2)), carry

    def __add__(self, other):
        s, _c = self.add_with_carry(other)
        return s

    __radd__ = __add__

    def sub_with_not_borrow(self, other, *, use_many: bool = False,
                            unsafe: bool = False):
        """(self - other mod 2^width, NOT-borrow ciphertext): radix-4
        complement add, ``a + (3 - b_i per digit) + 1``, so the carry
        chain is shared; not-borrow = 1 iff self >= other."""
        a, b = self._coerce(other)
        a._check_add(use_many, unsafe)
        three = int(_pbs.encode_int(MSG_MOD - 1, SPACE))
        one_body = int(_pbs.encode_int(1, SPACE))
        carry = None
        out = []
        for i in range(a.ndigits):
            # 3 - b_i: trivial(3) minus ciphertext, a linear negation.
            comp = tlwe.add_to_body(-b.digits[..., i, :], three)
            s = a.digits[..., i, :] + comp
            if carry is None:
                s = tlwe.add_to_body(s, one_body)  # +1 of the complement
            else:
                s = s + carry
            m, carry = a._extract_msg_carry(s, use_many, unsafe)
            out.append(m)
        return a._like(torch.stack(out, dim=-2)), carry

    def __sub__(self, other):
        d, _nb = self.sub_with_not_borrow(other)
        return d

    def __rsub__(self, other):
        a, b = self._coerce(other)
        return b - a

    def __neg__(self):
        return RadixUint.trivial(
            self.ctx, np.zeros(tuple(self.batch_shape), np.uint64), self.ndigits) - self

    # --------------------------- shifts ------------------------------- #
    def _zero_digits(self, count: int) -> torch.Tensor:
        z = torch.zeros(tuple(self.batch_shape) + (count,), dtype=torch.int32,
                        device=self.digits.device)
        return tlwe.trivial(z, self.ctx.params.n)

    def _extended(self, out_nd: int) -> "RadixUint":
        """Zero-extend (unsigned) to ``out_nd`` digits: free (trivial zero
        digits are noiseless)."""
        assert out_nd >= self.ndigits
        if out_nd == self.ndigits:
            return self
        return self._like(torch.cat(
            [self.digits, self._zero_digits(out_nd - self.ndigits)], dim=-2))

    def _shift1_parts(self, unsafe: bool = False):
        """One PBS level: per digit, (low-bit-at-weight-2, high-bit) fresh
        digits, the two pieces every odd-amount shift recombines linearly."""
        x = np.arange(SPACE, dtype=np.uint32)
        t_lo2 = ((x & 1) << 1).astype(np.uint32)   # low bit -> weight 2
        t_hi = ((x >> 1) & 1).astype(np.uint32)    # high bit -> weight 1
        nd = self.ndigits
        dstack = self.digits.movedim(-2, 0)
        cts = torch.cat([dstack, dstack])
        tabs = np.concatenate([np.tile(t_lo2, (nd, 1)), np.tile(t_hi, (nd, 1))])
        out = self._pbs_level(cts, tabs, unsafe=unsafe)
        return out[:nd], out[nd:]  # (nd, ..., n+1) each

    def shift_left(self, k: int, *, unsafe: bool = False) -> "RadixUint":
        """``self << k`` (wrapping) for a plaintext amount k: native digit
        re-indexing, no bit bridge.

        Even k: a pure digit re-index (trivial zeros shifted in), no PBS.
        Odd k: +1 PBS level (``_shift1_parts``) whose two outputs recombine
        linearly per digit (sum <= 3, a valid digit).  An odd-shifted digit
        carries two bootstrap outputs' variance: fed straight into an add,
        that level's worst input is 4 outputs instead of check_radix's 3
        (13.8 -> 11.9 calibrated sigma at PBS_PARAMS, still >= 5)."""
        if k < 0:
            raise ValueError(f"shift amount must be >= 0, got {k}")
        nd = self.ndigits
        if k == 0:
            return self
        if k >= self.width:
            return self._like(self._zero_digits(nd))
        q, r = divmod(k, MSG_BITS)
        digs = self.digits
        if r:
            lo2, hi = self._shift1_parts(unsafe=unsafe)
            planes = [lo2[0]]
            for i in range(1, nd):
                planes.append(lo2[i] + hi[i - 1])
            digs = torch.stack(planes, dim=-2)
        if q:
            digs = torch.cat([self._zero_digits(q), digs[..., : nd - q, :]], dim=-2)
        return self._like(digs)

    def shift_right(self, k: int, *, unsafe: bool = False) -> "RadixUint":
        """``self >> k`` (logical, zero-filled) for a plaintext amount, the
        mirror of ``shift_left``: even k free, odd k one PBS level.  On
        RadixInt this shifts the raw two's-complement pattern."""
        if k < 0:
            raise ValueError(f"shift amount must be >= 0, got {k}")
        nd = self.ndigits
        if k == 0:
            return self
        if k >= self.width:
            return self._like(self._zero_digits(nd))
        q, r = divmod(k, MSG_BITS)
        digs = self.digits
        if q:
            digs = torch.cat([digs[..., q:, :], self._zero_digits(q)], dim=-2)
        if r:
            src = RadixUint(self.ctx, digs)
            lo2, hi = src._shift1_parts(unsafe=unsafe)
            # right-by-1: digit i = (d_i >> 1) + 2 * (d_{i+1} & 1).
            planes = []
            for i in range(nd):
                d = hi[i]
                if i + 1 < nd:
                    d = d + lo2[i + 1]
                planes.append(d)
            digs = torch.stack(planes, dim=-2)
        return self._like(digs)

    def __lshift__(self, k: int):
        return self.shift_left(k)

    def __rshift__(self, k: int):
        return self.shift_right(k)

    # ----------------------- overflow flags --------------------------- #
    def _pbs_bit_to_gate(self, ct: torch.Tensor, table_on_space,
                         unsafe: bool = False) -> torch.Tensor:
        """One raw 1-lane PBS re-encoding a space-8 value as a gate bit."""
        return self._pbs_level(ct[None], _gate_tables(self.ctx, table_on_space), raw=True,
                               unsafe=unsafe)[0]

    def add_overflows(self, other, *, use_many: bool = False,
                      unsafe: bool = False):
        """(sum, overflow gate bit): unsigned overflow is the carry-out; one
        extra raw lookup re-encodes it for the boolean world."""
        s, carry = self.add_with_carry(other, use_many=use_many, unsafe=unsafe)
        x = np.arange(SPACE)
        ovf = self._pbs_bit_to_gate(carry, x >= 1, unsafe=unsafe)
        return s, ovf

    # ------------------------ multiplication -------------------------- #
    def _zero_digit(self) -> torch.Tensor:
        return self._zero_digits(1)[..., 0, :]

    def _mul_scalar(self, c: int, *, full: bool = False, unsafe: bool = False):
        """Plaintext-operand multiply: the scalar's bits fold into shifts,
        no bit-extraction level, no product level.  Each set bit k of c
        contributes ``self << k``; every odd-k row shares one
        ``shift_left(1)`` PBS level, and the rows reduce with the general
        multiply's batched add tree.

        8-bit truncated: 1 level (the shared odd shift, if c has odd set
        bits) + ceil(log2(popcount)) x nd add levels, e.g. x10 = 1 + 1 x 4
        = 5 levels.
        Odd-shifted digits carry 2 outputs' variance, so the first add
        round's worst input is 5 outputs against check_radix's 3 (13.8 ->
        10.7 calibrated sigma at PBS_PARAMS, still >= 5)."""
        ok, msg = check_radix(self.ctx.params)
        if not ok and not unsafe:
            raise ValueError(
                f"radix scalar-mul margin below threshold ({msg}); use "
                f"params.PBS_PARAMS or pass unsafe=True")
        nd = self.ndigits
        out_nd = 2 * nd if full else nd
        c &= (1 << (MSG_BITS * out_nd)) - 1
        if c == 0:
            return self._like(self._zero_digits(out_nd))
        base = self._extended(out_nd) if full else self
        odd = None
        rows = []
        for k in range(MSG_BITS * out_nd):
            if not (c >> k) & 1:
                continue
            if k % 2 and odd is None:
                odd = base.shift_left(1, unsafe=unsafe)  # shared level
            src = odd if k % 2 else base
            rows.append(src.shift_left(k - (k % 2), unsafe=unsafe).digits)
        arr = torch.stack(rows)
        return self._like(self._reduce_rows(arr, out_nd, unsafe))

    def _reduce_rows(self, arr: torch.Tensor, out_nd: int, unsafe: bool) -> torch.Tensor:
        """Batched binary add tree over stacked radix rows
        ``arr (R, ..., out_nd, n+1)`` -> digits (..., out_nd, n+1)."""
        zero = self._zero_digit()
        while arr.shape[0] > 1:
            if arr.shape[0] % 2:
                zrow = torch.stack([zero] * out_nd, dim=-2)[None].expand(
                    (1,) + tuple(arr.shape[1:]))
                arr = torch.cat([arr, zrow])
            s, _ = RadixUint(self.ctx, arr[0::2]).add_with_carry(
                RadixUint(self.ctx, arr[1::2]), unsafe=unsafe)
            arr = s.digits
        return arr[0]

    def mul(self, other, *, full: bool = False, unsafe: bool = False):
        """Schoolbook radix multiply, every PBS at a >= 5-sigma margin
        (``check_radix_mul``), no wide-space lookups:

        1. one level extracts both bits of every digit of ``b``;
        2. one level evaluates all digit-by-bit products through the
           bivariate index ``a_i + 4*b_bit`` (space-8 lookup ``(x & 3) *
           (x >> 2)``; products by a bit are <= 3, plain digits);
        3. the partial-product rows (the x2-weighted bit-1 rows entered
           twice) reduce in a batched binary add tree, ceil(log2(3*nd)) x
           nd bootstrap levels.

        8-bit (nd=4) truncated multiply: 2 + 4*4 = 18 bootstrap levels.
        ``full=True`` returns all 2*nd digits.  A plaintext ``other`` takes
        the shift-and-add path (``_mul_scalar``)."""
        if isinstance(other, (int, np.integer)):
            return self._mul_scalar(int(other), full=full, unsafe=unsafe)
        a, b = self._coerce(other)
        p = a.ctx.params
        ok1, m1 = check_radix(p)
        ok2, m2 = check_radix_mul(p)
        if not (ok1 and ok2) and not unsafe:
            raise ValueError(
                f"radix mul margin below threshold ({m1 if not ok1 else m2});"
                f" use params.PBS_PARAMS or pass unsafe=True")
        nd = a.ndigits
        out_nd = 2 * nd if full else nd
        # 1. both bits of every digit of b, one PBS level.
        dstack = b.digits.movedim(-2, 0)  # (nd, ..., n+1)
        cts = torch.cat([dstack, dstack])  # (2nd, ...)
        x = np.arange(SPACE, dtype=np.uint32)
        tabs = np.concatenate([np.tile(x & 1, (nd, 1)), np.tile((x >> 1) & 1, (nd, 1))])
        bits = self._pbs_level(cts, tabs, unsafe=unsafe)
        # 2. all digit-by-bit products in one PBS level.
        tab_mul = ((x & 3) * ((x >> 2) & 1)).astype(np.uint32)
        lanes = []
        for i in range(nd):
            for j in range(nd):
                if i + j >= out_nd:
                    continue
                ai = a.digits[..., i, :]
                for w in (0, 1):
                    lanes.append(ai + bits[j + w * nd] * 4)
        prods = self._pbs_level(torch.stack(lanes), np.tile(tab_mul, (len(lanes), 1)),
                                unsafe=unsafe)
        # 3. rows (plane shuffles, free), x2 rows twice; batched add tree.
        # Row (w, i) holds P_ij at digit position i+j: a valid radix number
        # (every digit <= 3).
        zero = self._zero_digit()
        rows_map: dict[tuple[int, int], dict[int, torch.Tensor]] = {}
        lane = 0
        for i in range(nd):
            for j in range(nd):
                if i + j >= out_nd:
                    continue
                for w in (0, 1):
                    rows_map.setdefault((w, i), {})[i + j] = prods[lane]
                    lane += 1
        assert lane == len(lanes)
        rows = []
        for (w, i), dig in sorted(rows_map.items()):
            row = torch.stack([dig.get(k, zero) for k in range(out_nd)], dim=-2)
            rows.append(row)
            if w == 1:  # x2 = enter the bit-1 row twice
                rows.append(row)
        arr = torch.stack(rows)  # (R, ..., out_nd, n+1)
        # _like keeps the signed/unsigned class (truncated product bits are
        # sign-agnostic; only the decrypt interpretation differs).
        return a._like(a._reduce_rows(arr, out_nd, unsafe))

    def __mul__(self, other):
        return self.mul(other)

    __rmul__ = __mul__

    # ------------------------- comparisons ---------------------------- #
    def _digit_rel_bits(self, other, unsafe: bool = False):
        """Per-digit (lt, eq) gate-encoded bit ciphertexts, one bootstrap
        level: lookup on d_i = a_i - b_i + 4 in [1, 7] with raw +-mu
        tables."""
        a, b = self._coerce(other)
        four = int(_pbs.encode_int(MSG_MOD, SPACE))
        d = tlwe.add_to_body(a.digits - b.digits, four)  # (..., nd, n+1), values in [1, 7]
        x = np.arange(SPACE)
        t_lt, t_eq = _gate_tables(a.ctx, x < MSG_MOD, x == MSG_MOD)
        # Lane axis = 2 * ndigits lookups, one batched raw PBS level.
        cts = torch.cat([d, d], dim=-2).movedim(-2, 0)  # (2*nd, ..., n+1)
        tabs = np.concatenate([np.tile(t_lt, (a.ndigits, 1)), np.tile(t_eq, (a.ndigits, 1))])
        out = self._pbs_level(cts, tabs, raw=True, unsafe=unsafe)
        lt = out[: a.ndigits].movedim(0, -2)
        eq = out[a.ndigits:].movedim(0, -2)
        return lt, eq  # (..., ndigits, n+1) gate bits

    def _compare(self, other, unsafe: bool = False):
        """(lt, eq) encrypted gate bits (composable with gates/ints)."""
        lt_d, eq_d = self._digit_rel_bits(other, unsafe=unsafe)
        ctx = self.ctx
        # MSB-first combine: lt = lt_hi | (eq_hi & lt_lo); eq = AND-tree.
        lt = lt_d[..., -1, :]
        eq = eq_d[..., -1, :]
        for i in range(self.ndigits - 2, -1, -1):
            lt = ctx.or_(lt, ctx.and_(eq, lt_d[..., i, :]))
            eq = ctx.and_(eq, eq_d[..., i, :])
        return lt, eq

    def lt(self, other, *, unsafe: bool = False):
        return self._compare(other, unsafe=unsafe)[0]

    def eq(self, other, *, unsafe: bool = False):
        return self._compare(other, unsafe=unsafe)[1]

    def le(self, other, *, unsafe: bool = False):
        lt, eq = self._compare(other, unsafe=unsafe)
        return self.ctx.or_(lt, eq)

    def gt(self, other, *, unsafe: bool = False):
        return tlwe.neg(self.le(other, unsafe=unsafe))

    def ge(self, other, *, unsafe: bool = False):
        return tlwe.neg(self.lt(other, unsafe=unsafe))

    def ne(self, other, *, unsafe: bool = False):
        return tlwe.neg(self.eq(other, unsafe=unsafe))

    # -------------------------- selection ----------------------------- #
    def select(self, cond, other, *, unsafe: bool = False) -> "RadixUint":
        """cond ? self : other with an encrypted gate-bit condition.

        PBS digits cannot be multiplied by a ciphertext, so the select runs
        in the bit world: both operands bridge to gate bits (one PBS
        level), the mux runs on bits (two gate levels), and the result
        bridges back (one PBS level), 4 bootstrap levels in all."""
        a, b = self._coerce(other)
        xa, xb = a.to_bits(unsafe=unsafe), b.to_bits(unsafe=unsafe)
        sel = xa.select(cond, xb)
        return type(a).from_bits(sel, ndigits=a.ndigits, unsafe=unsafe)

    def min_(self, other, *, unsafe: bool = False):
        a, b = self._coerce(other)
        return a.select(a.lt(b, unsafe=unsafe), b, unsafe=unsafe)

    def max_(self, other, *, unsafe: bool = False):
        a, b = self._coerce(other)
        return a.select(a.gt(b, unsafe=unsafe), b, unsafe=unsafe)

    # ------------------ bridge-backed derived ops --------------------- #
    # Division and bitwise ops have no native digit-wise form (bitwise ops
    # mix bits within a digit; restoring division needs per-round
    # encrypted selects): they run through the bit bridges, paying 2 extra
    # bootstrap levels on top of the bit-circuit cost.
    def _via_bits(self, other, op, unsafe: bool = False):
        a, b = self._coerce(other)
        out = op(a.to_bits(unsafe=unsafe), b.to_bits(unsafe=unsafe))
        return type(a).from_bits(out, ndigits=a.ndigits, unsafe=unsafe)

    def divmod(self, other, *, unsafe: bool = False):
        """(quotient, remainder): unsigned restoring division through the
        bit bridge (div-by-zero: q = all-ones, r = self)."""
        a, b = self._coerce(other)
        q_bits, r_bits = a.to_bits(unsafe=unsafe).divmod(b.to_bits(unsafe=unsafe))
        return (type(a).from_bits(q_bits, ndigits=a.ndigits, unsafe=unsafe),
                type(a).from_bits(r_bits, ndigits=a.ndigits, unsafe=unsafe))

    def __floordiv__(self, other):
        return self.divmod(other)[0]

    def __mod__(self, other):
        return self.divmod(other)[1]

    def __and__(self, other):
        return self._via_bits(other, lambda x, y: x & y)

    def __or__(self, other):
        return self._via_bits(other, lambda x, y: x | y)

    def __xor__(self, other):
        return self._via_bits(other, lambda x, y: x ^ y)

    # ----------------------- bit-world bridges ------------------------ #
    def to_bits(self, *, unsafe: bool = False) -> FheUint:
        """RadixUint -> ints.FheUint (gate-encoded bit planes), one
        bootstrap level: every digit's (bit0, bit1) looked up with raw
        +-mu tables in one batched PBS."""
        x = np.arange(SPACE)
        t_b0, t_b1 = _gate_tables(self.ctx, x & 1, (x >> 1) & 1)
        cts = torch.cat([self.digits, self.digits], dim=-2).movedim(-2, 0)
        tabs = np.concatenate([np.tile(t_b0, (self.ndigits, 1)),
                               np.tile(t_b1, (self.ndigits, 1))])
        out = self._pbs_level(cts, tabs, raw=True, unsafe=unsafe)
        b0 = out[: self.ndigits].movedim(0, -2)
        b1 = out[self.ndigits:].movedim(0, -2)
        bits = torch.stack([b0, b1], dim=-2)  # (..., nd, 2, n+1)
        return FheUint(self.ctx, bits.reshape(
            tuple(self.batch_shape) + (self.width, self.digits.shape[-1])))

    @classmethod
    def from_bits(cls, x: FheUint, *, ndigits: int | None = None,
                  unsafe: bool = False) -> "RadixUint":
        """ints.FheUint -> RadixUint, one bootstrap level: each gate bit is
        bootstrapped to the PBS-domain {0, 1} (space 8), then digits form
        as the linear combination b0 + 2*b1.

        The gate encoding is -1/8 / +1/8; adding 1/8 moves it onto the
        space-2 grid exactly (0 -> 0, 1 -> 1/4), so a two-bucket raw table
        {0: 0, 1: encode(1) at space 8} re-encodes each bit.  The table is
        shared by every bit: one (2,) operand for the whole batch."""
        ctx = x.ctx
        w = x.width
        nd = ndigits if ndigits is not None else (w + MSG_BITS - 1) // MSG_BITS
        if nd * MSG_BITS < w:
            raise ValueError(f"{nd} digits cannot hold {w} bits")
        one_enc = int(_pbs.encode_int(1, SPACE)) & 0xFFFFFFFF
        cts = tlwe.add_to_body(x.bits.movedim(-2, 0), 1 << 29)  # +1/8
        tab = np.array([0, one_enc], np.uint32)
        vals = _pbs.pbs(ctx.ck, cts, tab, space=2, params=ctx.params, raw=True,
                        unsafe=unsafe)
        vals = vals.movedim(0, -2)  # (..., w, n+1) PBS-domain bits
        digs = []
        for i in range(nd):
            d = vals[..., MSG_BITS * i, :]
            if MSG_BITS * i + 1 < w:
                d = d + vals[..., MSG_BITS * i + 1, :] * 2
            digs.append(d)
        return cls(ctx, torch.stack(digs, dim=-2))


class RadixInt(RadixUint):
    """Encrypted signed integer (two's complement over ``2 * ndigits``
    bits) in radix form.

    Wrapping add/sub/neg and the truncated multiply are digit-identical to
    the unsigned case (inherited); comparisons map signed order onto
    unsigned order by flipping the top digit's high bit (one extra 2-lane
    PBS level: ``x ^ 2`` is not linear on PBS digits); ``abs_`` routes
    through the bit bridge.  ``mul(full=True)`` uses the sign-extension
    identity ``a*b = a_u*b_u - 2^w(sa*b_u + sb*a_u)``."""

    @staticmethod
    def _to_digits(values, ndigits: int) -> np.ndarray:
        v = np.asarray(values)
        if np.issubdtype(v.dtype, np.signedinteger):
            v = v.astype(np.int64).view(np.uint64) & np.uint64(
                (1 << (MSG_BITS * ndigits)) - 1)
        return RadixUint._to_digits(v, ndigits)

    def decrypt(self) -> np.ndarray:
        val = super().decrypt()
        w = self.width
        sign = (val >> np.uint64(w - 1)) & np.uint64(1)
        return val.astype(np.int64) - (sign.astype(np.int64) << np.int64(w))

    def _like(self, digits) -> "RadixInt":
        return RadixInt(self.ctx, digits)

    def _bias_top(self, unsafe: bool = False):
        """Flip the top digit's high bit (x ^ 2) with one 1-lane PBS: maps
        two's-complement order onto unsigned order."""
        x = np.arange(SPACE, dtype=np.uint32)
        tab = np.where(x < MSG_MOD, x ^ 2, x)  # identity on the carry range
        top = self._pbs_level(self.digits[..., -1, :][None], tab[None], unsafe=unsafe)[0]
        return self._like(torch.cat([self.digits[..., :-1, :], top[..., None, :]], dim=-2))

    def _compare(self, other, unsafe: bool = False):
        a, b = self._coerce(other)
        return RadixUint._compare(a._bias_top(unsafe), b._bias_top(unsafe), unsafe=unsafe)

    def add_with_overflow(self, other, *, use_many: bool = False,
                          unsafe: bool = False):
        """(sum, signed-overflow gate bit): two's-complement overflow iff
        the operands share a sign the result does not; one raw 3-lane PBS
        level re-encodes the three sign bits, then ovf = !(sa ^ sb) & (sa ^
        ss) (two gate levels; the NOT is linear)."""
        a, b = self._coerce(other)
        s, _c = a.add_with_carry(b, use_many=use_many, unsafe=unsafe)
        x = np.arange(SPACE)
        t_sign = _gate_tables(a.ctx, (x >> 1) & 1)[0]
        tops = torch.stack([a.digits[..., -1, :], b.digits[..., -1, :], s.digits[..., -1, :]])
        bits = self._pbs_level(tops, np.tile(t_sign, (3, 1)), raw=True, unsafe=unsafe)
        sa, sb, ss = bits[0], bits[1], bits[2]
        ctx = a.ctx
        ovf = ctx.and_(tlwe.neg(ctx.xor(sa, sb)), ctx.xor(sa, ss))
        return s, ovf

    def mul(self, other, *, full: bool = False, unsafe: bool = False):
        """Signed multiply.  Truncated (default): digit-identical to the
        unsigned case.  ``full=True``: for w-bit two's complement,
        a = a_u - 2^w*sa, so

          a * b = a_u*b_u - 2^w*(sa*b_u + sb*a_u)   (mod 2^{2w})

        the unsigned full product of the raw digit patterns, corrected by
        the operands' magnitudes gated on the other's sign bit: 1 PBS level
        extracting both sign bits, 1 level for all sign-gated digit
        products (the multiply core's ``digit + 4*bit`` lookup), and 2
        subtraction chains over 2*nd digits; nd=4: 34 + 2 + 16 = 52
        levels."""
        if not full:
            return super().mul(other, full=False, unsafe=unsafe)
        if isinstance(other, (int, np.integer)):
            # A trivial operand keeps the correction arithmetic uniform (sb
            # is then a trivial bit).
            other = type(self).trivial(
                self.ctx,
                np.full(tuple(self.batch_shape), int(other) & ((1 << self.width) - 1),
                        np.uint64),
                self.ndigits)
        a, b = self._coerce(other)
        nd = a.ndigits
        # 1. unsigned full product of the raw digit patterns.
        prod_u = RadixUint(a.ctx, a.digits).mul(RadixUint(b.ctx, b.digits), full=True,
                                                unsafe=unsafe)
        # 2. both sign bits as PBS-domain {0,1}, one 2-lane level.
        x = np.arange(SPACE, dtype=np.uint32)
        t_sign = ((x >> 1) & 1).astype(np.uint32)
        tops = torch.stack([a.digits[..., -1, :], b.digits[..., -1, :]])
        sbits = self._pbs_level(tops, np.tile(t_sign, (2, 1)), unsafe=unsafe)
        sa, sb = sbits[0], sbits[1]
        # 3. sign-gated magnitudes sa*b_i, sb*a_i: one 2*nd-lane level.
        tab_mul = ((x & 3) * ((x >> 2) & 1)).astype(np.uint32)
        lanes = ([b.digits[..., i, :] + sa * 4 for i in range(nd)]
                 + [a.digits[..., i, :] + sb * 4 for i in range(nd)])
        prods = self._pbs_level(torch.stack(lanes), np.tile(tab_mul, (2 * nd, 1)),
                                unsafe=unsafe)

        # 4. corrections placed at digit offset nd (= << w, free), two subs.
        def _corr(digs_list):
            placed = torch.cat([self._zero_digits(nd), torch.stack(digs_list, dim=-2)], dim=-2)
            return RadixUint(a.ctx, placed)

        res = RadixUint(a.ctx, prod_u.digits)
        res, _ = res.sub_with_not_borrow(_corr([prods[i] for i in range(nd)]), unsafe=unsafe)
        res, _ = res.sub_with_not_borrow(_corr([prods[nd + i] for i in range(nd)]),
                                         unsafe=unsafe)
        return RadixInt(a.ctx, res.digits)

    def divmod(self, other, *, unsafe: bool = False):
        """Signed truncated division (C/Rust semantics) through the bit
        bridge (FheInt.divmod)."""
        a, b = self._coerce(other)
        fa = FheInt(a.ctx, a.to_bits(unsafe=unsafe).bits)
        fb = FheInt(b.ctx, b.to_bits(unsafe=unsafe).bits)
        q_bits, r_bits = fa.divmod(fb)
        return (type(a).from_bits(q_bits, ndigits=a.ndigits, unsafe=unsafe),
                type(a).from_bits(r_bits, ndigits=a.ndigits, unsafe=unsafe))

    def abs_(self, *, unsafe: bool = False):
        bits = self.to_bits(unsafe=unsafe)
        sbits = FheInt(self.ctx, bits.bits)
        return type(self).from_bits(FheInt(self.ctx, sbits.abs_().bits),
                                    ndigits=self.ndigits, unsafe=unsafe)
