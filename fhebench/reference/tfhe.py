"""Plain TFHE over Torus32 words: the benchmark's reference.

A straightforward implementation of the gate bootstrap and of
programmable bootstrapping, written from the scheme's definitions (the
upstream rusTfhe crate: ``tlwe.rs``, ``trlwe.rs``, ``trgsw.rs`` and the
decomposition of ``utils/src/math.rs``).  It imports torch and nothing
of the program under test, and takes nothing the program has made: the
keys are made here from the seed, and every table the program derives
from them (doubled key tables, key panels, prepared key-switch rows) is
worked out again from the raw keys.

Torus words are int32 tensors holding the uint32 bits.  Every product of
a digit and a key word is summed in float64, where every partial sum is
an integer below 2^53, so the sums are exact in any order and the result
is reduced mod 2^32.  ``dtype=torch.float32`` computes the same products
in float32: that is the control, the reference in the nearest precision
below its own, and it is not exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

TWO32 = 1 << 32


@dataclass(frozen=True)
class Params:
    """One parameter set, as a configuration file states it."""

    n: int
    N: int
    alpha_lv0: float
    alpha_lv1: float
    bgbit: int
    l: int
    iks_basebit: int
    iks_l: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        return cls(**{k: cfg[k] for k in cls.__dataclass_fields__})

    @property
    def nbit(self) -> int:
        return self.N.bit_length() - 1

    @property
    def iks_t(self) -> int:
        return 1 << self.iks_basebit

    @property
    def mu(self) -> int:
        """The gate constant 1/8."""
        return 1 << 29

    @property
    def decomp_mask(self) -> int:
        """The signed decomposition's rounding mask (``make_decomp_mask``,
        ``math.rs:542-560``): the half-digit bit of every level, plus the
        rounding bit below the last level, which the upstream loop adds
        twice when ``32 - l * bgbit`` is not 0, so that it carries one place
        up."""
        rem = 32 - self.l * self.bgbit
        u = 0
        if rem:
            u = 1 << (rem - 1)
            for i in range(self.l, 0, -1):
                u += 1 << (32 - i * self.bgbit - 1)
        else:
            for i in range(self.l - 1, 0, -1):
                u += 1 << (32 - i * self.bgbit - 1)
        return u % TWO32

    @property
    def iks_round(self) -> int:
        """The key switch's rounding constant (``tlwe.rs:50-54``)."""
        rem = 32 - self.iks_basebit * self.iks_l
        return (1 << (rem - 1)) if rem else 0


@dataclass
class Keys:
    """Secret keys s0 (n,) and s1 (N,) as int32 bits; the raw
    bootstrapping key bk (n, 2L, 2, N), row j < L carrying s0_i / Bg^(j+1)
    on the body and row L + j on the mask; the raw key-switching key ksk
    (N, iks_l, T, n+1), slot t - 1 encrypting t * s1_i / 2^(basebit (l+1))
    under s0 (slot T is made and never read, as the upstream key has it)."""

    s0: torch.Tensor
    s1: torch.Tensor
    bk: torch.Tensor
    ksk: torch.Tensor


def s32(v: int) -> int:
    """A uint32 value as the int32 Python int with the same bits."""
    v %= TWO32
    return v - TWO32 if v >= 1 << 31 else v


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Integer-valued tensor (int64, or float holding integers) -> the
    int32 words of its value mod 2^32."""
    if x.is_floating_point():
        x = torch.round(x)
    x = x.to(torch.int64)
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> their unsigned values as int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of 32-bit words, as int64 values."""
    return u32(x) >> k


# ------------------------------ sampling ------------------------------ #
def uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, tuple(shape), dtype=torch.int32,
                         generator=gen, device=device)


def gaussian(gen: torch.Generator, shape, alpha: float, device) -> torch.Tensor:
    """Rounded Gaussian noise of standard deviation ``alpha`` on the torus."""
    e = torch.randn(tuple(shape), dtype=torch.float64, generator=gen, device=device)
    return wrap(e * (alpha * TWO32))


def bits(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randint(0, 2, tuple(shape), dtype=torch.int32, generator=gen, device=device)


# --------------------------- ring arithmetic -------------------------- #
def negacyclic_matrix(q: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """The product by polynomial(s) ``q (..., N)`` in Z[X]/(X^N + 1) as a
    matrix ``(..., N_in, N_out)``: entry (i, k) is q[k - i] when k >= i and
    -q[N + k - i] when k < i."""
    N = q.shape[-1]
    i = torch.arange(N, device=q.device)
    d = i[None, :] - i[:, None]
    sign = torch.where(d >= 0, 1.0, -1.0).to(dtype)
    return q.to(dtype)[..., torch.remainder(d, N)] * sign


def times_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Torus polynomial(s) ``a (..., N)`` times the binary polynomial ``s``:
    |sum| <= N 2^31 < 2^53, exact in float64."""
    m = negacyclic_matrix(s)
    return wrap(a.to(torch.float64).reshape(-1, a.shape[-1]) @ m).reshape(a.shape)


def rotate(p: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """X^k p for polynomials ``p (R, H, N)`` and one power ``k (R,)`` in
    [0, 2N) per row: out[x] = p[j] for j = (x - k) mod 2N when j < N, and
    -p[j - N] when j >= N."""
    R, H, N = p.shape
    src = torch.remainder(torch.arange(N, device=p.device)[None, :] - k[:, None], 2 * N)
    neg = src >= N
    src = torch.where(neg, src - N, src)
    g = torch.gather(p, 2, src[:, None, :].expand(R, H, N))
    return torch.where(neg[:, None, :], -g, g)


def decompose(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Signed gadget digits of words ``x (...)``: ``(..., l)`` in
    [-Bg/2, Bg/2), most significant first (``math.rs:561-593``): add the
    rounding mask, XOR it back, cut into bgbit-wide fields, and read each
    field as signed."""
    m = s32(p.decomp_mask)
    v = u32((x + m) ^ m)
    shifts = torch.tensor([32 - p.bgbit * (j + 1) for j in range(p.l)], device=x.device)
    field = (v[..., None] >> shifts) & ((1 << p.bgbit) - 1)
    half = 1 << (p.bgbit - 1)
    return field - 2 * (field & half)


# -------------------------------- keys -------------------------------- #
def keygen(p: Params, gen: torch.Generator, device) -> Keys:
    """Secret and raw evaluation keys from ``gen``, in a few large calls."""
    s0 = bits(gen, (p.n,), device)
    s1 = bits(gen, (p.N,), device)
    a = uniform(gen, (p.n, 2 * p.l, p.N), device)
    body = times_binary(a, s1) + gaussian(gen, (p.n, 2 * p.l, p.N), p.alpha_lv1, device)
    bk = torch.stack([body, a], dim=2)  # (n, 2L, 2, N)
    for j in range(p.l):
        g = s0 << (32 - p.bgbit * (j + 1))
        bk[:, j, 0, 0] += g
        bk[:, p.l + j, 1, 0] += g
    t = torch.arange(1, p.iks_t + 1, device=device)
    shift = torch.tensor([32 - p.iks_basebit * (lv + 1) for lv in range(p.iks_l)], device=device)
    msg = wrap((s1.to(torch.int64)[:, None, None] * t[None, None, :]) << shift[None, :, None])
    ksk = encrypt(gen, s0, msg, p.alpha_lv0)
    return Keys(s0=s0, s1=s1, bk=bk.contiguous(), ksk=ksk)


# ----------------------------- TLWE level ------------------------------ #
def dot_key(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^32 for masks ``a (..., n)``: float64 sum of at most n
    words below 2^32, exact."""
    flat = u32(a.reshape(-1, a.shape[-1])).to(torch.float64)
    return wrap(flat @ s.to(torch.float64)).reshape(a.shape[:-1])


def encrypt(gen: torch.Generator, s: torch.Tensor, m: torch.Tensor, alpha: float) -> torch.Tensor:
    """TLWE of torus messages ``m`` (int32, any shape) under ``s (n,)``:
    ``(..., n+1)``, body first."""
    a = uniform(gen, tuple(m.shape) + (s.shape[0],), s.device)
    b = dot_key(a, s) + gaussian(gen, m.shape, alpha, s.device) + m
    return torch.cat([b[..., None], a], dim=-1)


def phase(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return ct[..., 0] - dot_key(ct[..., 1:], s)


def decrypt_bits(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Gate encoding +-1/8: a phase below 1/2 is 1."""
    return (phase(ct, s) >= 0).to(torch.int64)


def encode_int(x: torch.Tensor, space: int) -> torch.Tensor:
    """Padding-bit encoding: x -> x / (2 space) on the torus."""
    return wrap((x.to(torch.int64) % (2 * space)) * (TWO32 // (2 * space)))


def decrypt_int(ct: torch.Tensor, s: torch.Tensor, space: int) -> torch.Tensor:
    """The nearest bucket in [0, 2 space) of the phase."""
    step = TWO32 // (2 * space)
    return ((u32(phase(ct, s)) + step // 2) // step) % (2 * space)


def bit_words(b: torch.Tensor) -> torch.Tensor:
    """{0, 1} -> +-1/8."""
    return torch.where(b != 0, s32(1 << 29), s32(-(1 << 29))).to(torch.int32)


# ------------------------------ bootstrap ------------------------------ #
def blind_rotate(ct: torch.Tensor, bk: torch.Tensor, testvec: torch.Tensor, p: Params,
                 dtype=torch.float64) -> torch.Tensor:
    """X^(-phase~) testvec for lv0 TLWE rows ``ct (R, n+1)`` and one test
    vector per row ``testvec (R, 2, N)`` (trivial TRLWE): the modulus
    switch (b~ floored, a~ rounded to Z_2N), then n CMux steps
    acc += BK_i [x] (X^a~_i acc - acc).  Returns int32 (R, 2, N)."""
    R = ct.shape[0]
    shift = 32 - p.nbit - 1
    b_t = srl(ct[:, 0], shift)
    a_t = srl(ct[:, 1:] + s32(1 << (shift - 1)), shift)  # (R, n)
    acc = rotate(testvec, torch.remainder(-b_t, 2 * p.N))
    for i in range(p.n):
        diff = rotate(acc, a_t[:, i]) - acc
        d = decompose(diff, p).movedim(-1, -2).reshape(R, 2 * p.l * p.N)  # (R, 2L N)
        m = negacyclic_matrix(bk[i], dtype)  # (2L, 2, N_in, N_out)
        m = m.permute(0, 2, 1, 3).reshape(2 * p.l * p.N, 2 * p.N)
        acc = acc + wrap(d.to(dtype) @ m).reshape(R, 2, p.N)
    return acc


def sample_extract(acc: torch.Tensor, index: int) -> torch.Tensor:
    """TLWE (R, N+1) of coefficient ``index`` of TRLWE rows (R, 2, N)."""
    N = acc.shape[-1]
    src = index - torch.arange(N, device=acc.device)
    a = acc[:, 1, :][:, torch.remainder(src, N)]
    a = torch.where(src >= 0, a, -a)
    return torch.cat([acc[:, 0, index:index + 1], a], dim=-1)


def key_switch(lv1: torch.Tensor, ksk: torch.Tensor, p: Params, block: int = 8) -> torch.Tensor:
    """lv1 TLWE (R, N+1) -> lv0 TLWE (R, n+1): b minus the sum of the key
    rows KS[i][l][d - 1] over every nonzero unsigned digit d of the
    rounded mask words (``tlwe.rs:43-73``), summed in int64 and reduced."""
    T = p.iks_t
    flat = ksk.reshape(-1, p.n + 1).to(torch.int64)
    flat = torch.cat([flat, torch.zeros_like(flat[:1])])  # a zero row for d = 0
    zero = flat.shape[0] - 1
    shifts = torch.tensor([32 - p.iks_basebit * (lv + 1) for lv in range(p.iks_l)],
                          device=lv1.device)
    base = (torch.arange(p.N, device=lv1.device)[:, None] * p.iks_l
            + torch.arange(p.iks_l, device=lv1.device)[None, :]) * T
    out = []
    for r in range(0, lv1.shape[0], block):
        rows = lv1[r:r + block]
        d = (u32(rows[:, 1:] + s32(p.iks_round))[..., None] >> shifts) & (T - 1)  # (b, N, l)
        idx = torch.where(d > 0, base[None] + d - 1, zero).reshape(rows.shape[0], -1)
        acc = flat[idx].sum(dim=1)  # (b, n+1)
        acc[:, 0] = u32(rows[:, 0]) - acc[:, 0]
        acc[:, 1:] = -acc[:, 1:]
        out.append(wrap(acc))
    return torch.cat(out)


def gate_testvec(p: Params, rows: int, device) -> torch.Tensor:
    tv = torch.zeros((rows, 2, p.N), dtype=torch.int32, device=device)
    tv[:, 0, :] = p.mu
    return tv


def lut_testvec(tables: torch.Tensor, space: int, p: Params, raw: bool) -> torch.Tensor:
    """Tables (R, t, space) -> staircase test vectors (R, 2, N): coefficient
    c holds table[c mod t] at bucket c // (N / space), so that a rotation
    by a multiple of t extracts table j's entry at coefficient j."""
    R, t, _ = tables.shape
    vals = tables.to(torch.int64)
    vals = wrap(vals) if raw else encode_int(vals, space)
    c = torch.arange(p.N, device=tables.device)
    picked = vals[:, c % t, c // (p.N // space)]  # (R, N)
    tv = torch.zeros((R, 2, p.N), dtype=torch.int32, device=tables.device)
    tv[:, 0, :] = picked
    return tv


def pbs_input(ct: torch.Tensor, space: int, t: int, p: Params) -> torch.Tensor:
    """The half-bucket offset 1/(4 space) on the body, then, for t > 1
    lookups, every word rounded to the grid that makes the rotation a
    multiple of t."""
    ct = ct.clone()
    ct[:, 0] = ct[:, 0] + s32(TWO32 // (4 * space))
    tau = t.bit_length() - 1
    if tau:
        g = 32 - p.nbit - 1 + tau
        ct = wrap(((u32(ct) + (1 << (g - 1))) >> g) << g)
    return ct


def bootstrap_rows(ct: torch.Tensor, testvec: torch.Tensor, keys: Keys, p: Params,
                   extract: int = 1, switch: bool = True, dtype=torch.float64) -> torch.Tensor:
    """Rotate, extract coefficients 0..extract-1, and key switch unless
    ``switch`` is False: (R, n+1) -> (R, extract, n+1 or N+1)."""
    acc = blind_rotate(ct, keys.bk, testvec, p, dtype)
    lv1 = torch.stack([sample_extract(acc, j) for j in range(extract)], dim=1)
    if not switch:
        return lv1
    R = ct.shape[0]
    return key_switch(lv1.reshape(R * extract, p.N + 1), keys.ksk, p).reshape(R, extract, -1)


def gate_bootstrap(pre: torch.Tensor, keys: Keys, p: Params, dtype=torch.float64,
                   switch: bool = True) -> torch.Tensor:
    """The gate bootstrap of pre-combined rows (R, n+1): lv0 (R, n+1), or
    lv1 (R, N+1) without the key switch."""
    tv = gate_testvec(p, pre.shape[0], pre.device)
    return bootstrap_rows(pre, tv, keys, p, 1, switch, dtype)[:, 0]


def pbs(ct: torch.Tensor, tables: torch.Tensor, space: int, raw: bool, keys: Keys, p: Params,
        dtype=torch.float64) -> torch.Tensor:
    """Programmable bootstrap with t tables per row: ct (R, n+1), tables
    (R, t, space) -> (R, t, n+1), row j encrypting tables[j][x]."""
    t = tables.shape[1]
    tv = lut_testvec(tables, space, p, raw)
    return bootstrap_rows(pbs_input(ct, space, t, p), tv, keys, p, t, True, dtype)


# -------------------------------- gates -------------------------------- #
PRE = {  # (ca, cb, c_mu): pre = ca x + cb y + c_mu mu
    "nand": (-1, -1, 1),
    "and": (1, 1, -1),
    "or": (1, 1, 1),
    "xor": (2, 2, 2),
    "not": (-1, 0, 0),
    "andn": (-1, 1, -1),
}


def precombine(op: str, x: torch.Tensor, y: torch.Tensor | None, p: Params) -> torch.Tensor:
    ca, cb, cm = PRE[op]
    pre = x * ca
    if cb:
        pre = pre + y * cb
    pre[:, 0] += s32(cm * p.mu)
    return pre


def gate(op: str, cts: list[torch.Tensor], keys: Keys, p: Params,
         dtype=torch.float64) -> torch.Tensor:
    """One bootstrapped gate of TLWE rows: NAND, AND, OR, XOR, NOT, each a
    linear pre-combination and one bootstrap; MUX(c, in0, in1) as
    AND(c, in1) and ANDN(c, in0) bootstrapped together, then their OR."""
    if op != "mux":
        return gate_bootstrap(precombine(op, cts[0], cts[1] if len(cts) > 1 else None, p),
                              keys, p, dtype)
    c, in0, in1 = cts
    R = c.shape[0]
    both = gate_bootstrap(torch.cat([precombine("and", c, in1, p),
                                     precombine("andn", c, in0, p)]), keys, p, dtype)
    return gate_bootstrap(precombine("or", both[:R], both[R:], p), keys, p, dtype)

