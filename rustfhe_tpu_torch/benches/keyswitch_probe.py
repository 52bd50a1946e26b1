"""The identity key switch in seven forms, checked and timed.

Counterpart of ``benches/keyswitch_probe.py``.  The key switch takes an lv1
TLWE (B, N+1) to lv0 (B, n+1): the mask's unsigned digits (B, N, iks_l),
each in [0, T), select rows of the KSK and the selected rows are summed.
Q = N * iks_l * (T - 1) is the one-hot width (24576 at DEFAULT_PARAMS).

  current      the port's ``bootstrap.identity_key_switch``: T - 1 float64
               (digit == t) mask GEMMs against the float64 KSK
  onehot_int8  the JAX package's production form: the one-hot (B, Q) int8
               against the KSK's int8 limbs (Q, (n+1)*4) on the port's
               int8 GEMM (P9, ``int8_gemm.int8_matmul``), then the limb
               recombination.  The GEMM's tile is 256 columns wide and
               (n+1)*4 = 2544 is not a multiple of 256, so the limb columns
               are padded with zeros to 2560 (once, outside the timing)
  onehot_int_mm  the same with ``torch._int_mm`` (cuBLASLt), the library
               yardstick
  dot_only     the one-hot prebuilt: the GEMM and the recombination alone
  build_only   the decomposition and the one-hot, and a cheap reduction in
               place of the GEMM (not a key switch: not checked)
  masks3       T - 1 (B, N*iks_l) int8 mask GEMMs on P9, summed
  chunked4     the one-hot GEMM on P9 in 4 row chunks, summed
  bf16         the one-hot GEMM in bf16 with fp32 sums (exact: each sum is
               at most N*iks_l*2^7 = 2^20 < 2^24)

Every form but build_only must equal ``identity_key_switch`` word for
word on 64 rows before any timing (``check``, any device: on the CPU the
GEMMs are their plain versions).  Timing: a chain per form, the output
tiled back up to (B, N+1) as the next input, between CUDA events
(``_timing.chain``); each line gives ms per switch, TMAC/s and the share
of the int8 bound, 2*B*Q*(n+1)*4 ops over the card's int8 peak.

Usage: python -m rustfhe_tpu_torch.benches.keyswitch_probe [B]
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import _u32, keys
from ..bootstrap import identity_key_switch
from ..decomp import decompose_unsigned
from ..engine import int8_gemm, plain
from ..engine.matmul import MatmulEngine, recombine
from ..params import DEFAULT_PARAMS, TFHEParams
from . import _timing
from ._timing import Case

DEFAULT_B = 8192
CHECK_ROWS = 64
LIMBS = MatmulEngine().num_limbs  # 8-bit limbs of a KSK word
LIMB_BITS = MatmulEngine().limb_bits
CHECKED = ("onehot_int8", "onehot_int_mm", "dot_only", "masks3", "chunked4", "bf16")


def q_width(p: TFHEParams) -> int:
    return p.N * p.iks_l * (p.iks_t - 1)


def macs(B: int, p: TFHEParams) -> int:
    """int8 MACs of the one-hot product of one key switch."""
    return B * q_width(p) * (p.n + 1) * LIMBS


class Forms:
    """The forms on one KSK: ``ksk`` the port's float64 slots, ``ksk8``
    JAX's int8 limb layout (Q, (n+1)*K), and its padded transpose for P9."""

    def __init__(self, ksk_raw: torch.Tensor, p: TFHEParams):
        self.p = p
        self.ksk = plain.prepare_ksk(ksk_raw, p)
        self.ksk8 = MatmulEngine().prepare_ksk(ksk_raw, p)  # (Q, (n+1)*K)
        cols = self.ksk8.shape[1]
        _, bn = int8_gemm.tile_shape(int8_gemm.TILE)
        self.cols = cols
        self.ksk8t = F.pad(self.ksk8.t(), (0, 0, 0, -cols % bn)).contiguous()  # (2560, Q)
        self.ksk_bf16 = self.ksk8.to(torch.bfloat16)
        rows = p.N * p.iks_l
        slots = self.ksk8t.reshape(-1, rows, p.iks_t - 1)
        self.slots_t = [slots[:, :, t].contiguous() for t in range(p.iks_t - 1)]
        step = self.ksk8t.shape[1] // 4
        self.chunks_t = [self.ksk8t[:, j * step: (j + 1) * step].contiguous() for j in range(4)]

    # the pieces
    def digits(self, c: torch.Tensor) -> torch.Tensor:
        return decompose_unsigned(c[:, 1:], self.p)  # (B, N, iks_l)

    def onehot(self, d: torch.Tensor) -> torch.Tensor:
        """(B, N, iks_l) digits -> (B, Q) int8, column (i, l, t-1) = (d == t)."""
        t = torch.arange(1, self.p.iks_t, dtype=d.dtype, device=d.device)
        return (d[..., None] == t).to(torch.int8).reshape(d.shape[0], -1)

    def p9(self, d: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
        """d (M, K) int8 @ wt.T on P9, rows padded to the tile; (M, cols)."""
        bm, _ = int8_gemm.tile_shape(int8_gemm.TILE)
        M, K = d.shape
        if M % bm or K % int8_gemm.DEPTH:
            d = F.pad(d, (0, -K % int8_gemm.DEPTH, 0, -M % bm))
            wt = F.pad(wt, (0, -K % int8_gemm.DEPTH))
        return int8_gemm.int8_matmul(d.contiguous(), wt.contiguous())[:M, : self.cols]

    def finish(self, c: torch.Tensor, limb_sums: torch.Tensor) -> torch.Tensor:
        """b - recombined sums: (B, (n+1)*K) int32 -> lv0 (B, n+1)."""
        parts = limb_sums.reshape(c.shape[0], self.p.n + 1, LIMBS).transpose(-1, -2)
        out = -recombine(parts, LIMB_BITS)
        out[:, 0] += c[:, 0]
        return out

    # the forms: lv1 (B, N+1) -> lv0 (B, n+1)
    def current(self, c):
        return identity_key_switch(c, self.ksk, self.p)

    def onehot_int8(self, c):
        return self.finish(c, self.p9(self.onehot(self.digits(c)), self.ksk8t))

    def onehot_int_mm(self, c):
        # the weights column-major, the layout cuBLASLt's int8 GEMM takes
        return self.finish(c, torch._int_mm(self.onehot(self.digits(c)),
                                            self.ksk8t[: self.cols].t()))

    def dot_only(self, c, oh):
        return self.finish(c, self.p9(oh, self.ksk8t))

    def build_only(self, c):
        oh = self.onehot(self.digits(c))
        s = oh.reshape(c.shape[0], -1, 128).sum(dim=-1, dtype=torch.int32)  # (B, Q/128)
        s = s.repeat(1, (self.p.n + 1) // s.shape[1] + 1)[:, : self.p.n + 1]
        out = -s
        out[:, 0] += c[:, 0]
        return out

    def masks3(self, c):
        p = self.p
        d = self.digits(c).reshape(c.shape[0], p.N * p.iks_l)
        sums = None
        for t in range(1, p.iks_t):
            part = self.p9((d == t).to(torch.int8), self.slots_t[t - 1])
            sums = part if sums is None else sums + part
        return self.finish(c, sums)

    def chunked4(self, c):
        oh = self.onehot(self.digits(c))
        step = oh.shape[1] // 4
        sums = None
        for j in range(4):
            part = self.p9(oh[:, j * step: (j + 1) * step], self.chunks_t[j])
            sums = part if sums is None else sums + part
        return self.finish(c, sums)

    def bf16(self, c):
        oh = self.onehot(self.digits(c))
        if oh.is_cuda:
            sums = torch.mm(oh.to(torch.bfloat16), self.ksk_bf16, out_dtype=torch.float32)
        else:  # the plain version: the same integers in float64
            sums = oh.to(torch.float64) @ self.ksk8.to(torch.float64)
        return self.finish(c, sums.to(torch.int32))


def setup(B: int, p: TFHEParams, device) -> tuple[Forms, torch.Tensor]:
    """The KSK from a torch generator seeded 9 and the lv1 words (B, N+1)
    from numpy seed 11."""
    gen = torch.Generator(device=device).manual_seed(9)
    sk = keys.gen_secret_key(gen, p, device)
    forms = Forms(keys.gen_key_switching_key_raw(gen, sk, p), p)
    rs = np.random.RandomState(11)
    ct = _u32.from_numpy(rs.randint(0, 2**32, size=(B, p.N + 1), dtype=np.uint64), device)
    return forms, ct


def check(forms: Forms, ct: torch.Tensor, out=print) -> None:
    """Every checked form equal to ``identity_key_switch`` word for word on
    the first CHECK_ROWS rows; raises on a difference."""
    small = ct[:CHECK_ROWS]
    want = forms.current(small)
    for name in CHECKED:
        got = (forms.dot_only(small, forms.onehot(forms.digits(small))) if name == "dot_only"
               else getattr(forms, name)(small))
        if not torch.equal(got, want):
            raise AssertionError(f"key switch form {name} differs from identity_key_switch")
    out(f"# exactness: {', '.join(CHECKED)} equal to identity_key_switch on "
        f"{small.shape[0]} rows")


def cases(forms: Forms, ct: torch.Tensor) -> list:
    p, B = forms.p, ct.shape[0]
    reps = (p.N + 1 + p.n) // (p.n + 1)

    def chained(fn):
        return lambda c: fn(c).repeat(1, reps)[:, : p.N + 1].contiguous()

    oh = forms.onehot(forms.digits(ct))
    ops = 2 * macs(B, p)
    bound = _timing.bound(ops=ops)[0] / 1e3
    out = []
    for name in ("current", "onehot_int8", "onehot_int_mm", "dot_only", "build_only",
                 "masks3", "chunked4", "bf16"):
        fn = ((lambda c: forms.dot_only(c, oh)) if name == "dot_only"
              else getattr(forms, name))
        out.append(Case(name, chained(fn), ct, ops / 2, "TMAC/s", bound_s=bound))
    return out


def run(B: int = DEFAULT_B, steps: int = _timing.STEPS, reps: int = _timing.REPS,
        out=print) -> dict[str, float]:
    """Check, then time every form at batch B on the card; {form: seconds
    per key switch}."""
    device = _timing.require_cuda()
    p = DEFAULT_PARAMS
    _timing.header(f"identity key switch forms, Q={q_width(p)}", B, out)
    forms, ct = setup(B, p, device)
    check(forms, ct, out)
    out(f"# one-hot product: (B, {q_width(p)}) x ({q_width(p)}, {forms.cols}) int8; P9's tile "
        f"takes {forms.ksk8t.shape[0]} columns (zero-padded); int8 bound "
        f"{_timing.bound(ops=2 * macs(B, p))[0]:.4f} ms")
    return _timing.run_cases(cases(forms, ct), steps, reps, out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else DEFAULT_B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
