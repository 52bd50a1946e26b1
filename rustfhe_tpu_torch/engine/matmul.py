"""The generic dense-matmul engines ``"matmul"`` and ``"matmul_bf16"``.

Counterpart of ``rustfhe_tpu/engine/matmul.py`` (``MatmulEngine``).  The
negacyclic external product is one dense integer matrix product per
blind-rotate step:

  out[c] = sum_j digits_j (*) row[j][c]

Each key polynomial is split into K balanced signed limbs of ``limb_bits``
bits (the JAX table's order, ``[limbs(q), limbs(-q)]`` over 2N, which is
the port's ``plain.prepare_trgsw_limbs`` with the halves swapped), a
circulant operand is built from the table per step, and the digits
(|d| <= Bg/2) times the limbs accumulate exactly:

  |sum| <= 2L*N * (Bg/2) * 2^(limb_bits-1)
        =  6144 * 32 * 128 ~ 2^24.6   ("matmul", int8 x int8 -> int32)
        =  6144 * 32 * 8   ~ 2^20.6   ("matmul_bf16", bf16 x bf16 -> fp32)

The limbs recombine with wrapping shifts, exact mod 2^32.

* ``"matmul"``: on the card the product runs on the port's own int8
  tensor-core GEMM (``int8_gemm.int8_matmul``, the kernel of P7/P9, at its
  default tile ``int8_gemm.TILE``), its batch rows padded to the tile; on
  the CPU that wrapper runs its plain version.  Digits are cast to int8 as
  the JAX engine casts them, so at half_bg > 128 they wrap and the engine
  fails the oracle probe, as JAX's does.
* ``"matmul_bf16"``: K = 8 limbs of 4 bits; on the card a bf16 GEMM with
  fp32 output (``torch.mm(..., out_dtype=torch.float32)``: cuBLAS with an
  fp32 compute type, so no reduction runs in bf16 whatever
  ``allow_bf16_reduced_precision_reduction`` says), on the CPU a float64
  product of the same integers.  Digits up to 2^8 and limbs up to 2^3 are
  exact in bf16, and every sum is below 2^24, exact in fp32.  The JAX
  package computes this product outside any Pallas kernel (XLA's dot), so
  the port leaves it to the library too.

The identity key switch (``prepare_ksk`` / ``key_switch_digits``) and the
torus x binary product are the JAX engine's, as float64 products of the
same limbs (exact: every sum is far below 2^53); the bootstrap keeps the
port's float64 key switch (``engine.plain``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .._u32 import wrap
from ..params import TFHEParams
from ..poly import to_signed_limbs
from . import int8_gemm
from .launch import dispatch


def recombine(parts: torch.Tensor, limb_bits: int) -> torch.Tensor:
    """int32 limb sums ``(..., K, n)`` -> int32 words ``(..., n)``:
    sum_k parts_k << (limb_bits * k), wrapping mod 2^32 (int32 shifts and
    adds wrap in torch)."""
    out = parts[..., 0, :].clone()
    for k in range(1, parts.shape[-2]):
        out += parts[..., k, :] << (limb_bits * k)
    return out


def circulant(table: torch.Tensor) -> torch.Tensor:
    """Doubled limb table ``(R, 2, K, 2N)`` int8 -> the GEMM's weights
    ``wt`` int8 ``(2*K*N, R*N)``, the layout ``int8_gemm.int8_matmul``
    reads (``prepare_rhs``: one row per output column), for digits taken
    in reversed coefficient order:

      wt[(c, k, n), (j, m')] = table[j, c, k, (n - (N-1-m')) mod 2N]

    Built without a gather: with Q2[z] = table[(z - N + 1) mod 2N] (a
    roll of the small table), row n is the window Q2[n : n + N], so the
    whole operand is one strided copy of sliding windows (``unfold``).
    Reversing the digits (``external_product_digits``) is what makes every
    window run forwards."""
    R, halves, K, tn = table.shape
    N = tn // 2
    q2 = torch.roll(table, N - 1, dims=-1)[..., : tn - 1]
    win = q2.unfold(-1, N, 1)  # (R, 2, K, n, m') = Q2[n + m']
    return win.permute(1, 2, 3, 0, 4).reshape(halves * K * N, R * N)


@dataclass(frozen=True)
class MatmulEngine:
    """Dense-matmul negacyclic convolution engine (``limb_bits`` 8: int8
    tensor-core GEMM; 4 with ``use_bf16``: bf16 GEMM, fp32 sums)."""

    limb_bits: int = 8
    use_bf16: bool = False

    def __post_init__(self):
        if 32 % self.limb_bits:
            raise ValueError(f"limb_bits must divide 32, got {self.limb_bits}")

    @property
    def name(self) -> str:
        return "matmul_bf16" if self.use_bf16 else "matmul"

    @property
    def num_limbs(self) -> int:
        return 32 // self.limb_bits

    # ------------------------------------------------------------------ #
    # Preparation
    # ------------------------------------------------------------------ #
    def prepare_trgsw(self, rows: torch.Tensor, params: TFHEParams | None = None) -> torch.Tensor:
        """TRGSW rows int32 ``(..., 2L, 2, N)`` -> the doubled limb table
        int8 ``(..., 2L, 2, K, 2N)``, ``[limbs(q), limbs(-q)]`` (JAX's
        order).  -q is split on its own: a limb of -2^(limb_bits-1) has no
        negation in range."""
        pos = to_signed_limbs(rows, self.limb_bits, self.num_limbs).movedim(-1, -2)
        neg = to_signed_limbs(-rows, self.limb_bits, self.num_limbs).movedim(-1, -2)
        return torch.cat([pos, neg], dim=-1).contiguous()

    # ------------------------------------------------------------------ #
    # External product
    # ------------------------------------------------------------------ #
    def product(self, d: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
        """d ``(M, D)`` small integers @ ``wt.T`` (``wt`` int8 ``(C, D)``)
        -> int32 ``(M, C)``, exact."""
        if self.use_bf16:
            if dispatch(d.device):
                # bf16 operands, fp32 output and fp32 compute: exact here (see
                # the module docstring); TF32 and bf16 reduction flags do not apply.
                out = torch.mm(d.to(torch.bfloat16), wt.t().to(torch.bfloat16),
                               out_dtype=torch.float32)
            else:
                out = d.to(torch.float64) @ wt.t().to(torch.float64)
            return out.to(torch.int32)
        d = d.to(torch.int8)
        M, D = d.shape
        C = wt.shape[0]
        bm, bn = int8_gemm.tile_shape(int8_gemm.TILE)
        pad_m, pad_d, pad_c = -M % bm, -D % int8_gemm.DEPTH, -C % bn
        if pad_m or pad_d:
            d = F.pad(d, (0, pad_d, 0, pad_m))
        if pad_d or pad_c:
            wt = F.pad(wt, (0, pad_d, 0, pad_c))
        out = int8_gemm.int8_matmul(d.contiguous(), wt.contiguous())
        return out[:M, :C] if pad_m or pad_c else out

    def external_product_digits(self, prepared: torch.Tensor, digits: torch.Tensor,
                                params: TFHEParams) -> torch.Tensor:
        """``prepared`` int8 ``(2L, 2, K, 2N)``; ``digits`` integers
        ``(..., 2L, N)`` -> int32 ``(..., 2, N)``."""
        return recombine(self.limb_sums(prepared, digits, params), self.limb_bits)

    def limb_sums(self, prepared: torch.Tensor, digits: torch.Tensor,
                  params: TFHEParams) -> torch.Tensor:
        """The product's exact int32 sums per limb before ``recombine``:
        ``prepared`` int8 ``(R, 2, K, 2N)`` and ``digits`` ``(..., R, N)``
        for any R rows (2L, or a tensor-parallel shard of them) -> int32
        ``(..., 2, K, N)``, each at most the module docstring's bound, so
        sums over row shards add exactly in int32 (the JAX
        ``_TPMatmulEngine``'s psum)."""
        N = params.N
        lead = digits.shape[:-2]
        rows = digits.shape[-2]
        d = digits.flip(-1).reshape(-1, rows * N)
        out = self.product(d, circulant(prepared))
        return out.reshape(lead + (2, self.num_limbs, N))

    # ------------------------------------------------------------------ #
    # Identity key switch
    # ------------------------------------------------------------------ #
    def prepare_ksk(self, ksk_raw: torch.Tensor, params: TFHEParams) -> torch.Tensor:
        """Raw KSK int32 ``(N, iks_l, T, n+1)`` -> int8
        ``(N*iks_l*(T-1), (n+1)*K)``: slot T (digit 0) dropped, every word
        limb-split (JAX's layout)."""
        used = ksk_raw[:, :, : params.iks_t - 1, :]
        q = params.N * params.iks_l * (params.iks_t - 1)
        limbs = to_signed_limbs(used.reshape(q, -1), self.limb_bits, self.num_limbs)
        return limbs.reshape(q, -1).contiguous()

    def key_switch_digits(self, prepared: torch.Tensor, digits: torch.Tensor,
                          params: TFHEParams) -> torch.Tensor:
        """``digits`` ``(..., N, iks_l)`` in [0, T) -> sum_{i,l}
        KS[i, l, d] as int32 ``(..., n+1)``: one (digit == t) mask product
        per nonzero slot t, float64 (|sum| <= N*iks_l * 2^(limb_bits-1))."""
        nslots = params.iks_t - 1
        il = params.N * params.iks_l
        lead = digits.shape[:-2]
        d = digits.reshape(-1, il)
        ks3 = prepared.reshape(il, nslots, prepared.shape[-1]).to(torch.float64)
        out = None
        for t in range(1, params.iks_t):
            part = (d == t).to(torch.float64) @ ks3[:, t - 1]
            out = part if out is None else out + part
        out = wrap(out).reshape(-1, out.shape[-1] // self.num_limbs, self.num_limbs)
        return recombine(out.transpose(-1, -2), self.limb_bits).reshape(lead + (-1,))

    # ------------------------------------------------------------------ #
    # Torus x binary polynomial product
    # ------------------------------------------------------------------ #
    def poly_mul_torus_binary(self, a: torch.Tensor, s: torch.Tensor,
                              params: TFHEParams | None = None) -> torch.Tensor:
        """``a`` int32 ``(..., N)`` torus; ``s`` {0,1} ``(N,)`` -> int32
        ``(..., N)``: limbs of a times the circulant of s (|sum| <= N *
        2^(limb_bits-1)), float64."""
        N = a.shape[-1]
        sd = torch.cat([s, -s]).to(torch.float64)
        ar = torch.arange(N, device=a.device)
        circ = sd[torch.remainder(ar[None, :] - ar[:, None], 2 * N)]  # (m, n)
        limbs = to_signed_limbs(a, self.limb_bits, self.num_limbs).movedim(-1, -2)
        prod = wrap(limbs.to(torch.float64) @ circ)  # (..., K, N)
        return recombine(prod, self.limb_bits)
