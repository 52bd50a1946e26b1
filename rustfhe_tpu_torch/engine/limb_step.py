"""The limb-form CMux steps (K4, K6) and external product (K5).

Counterpart of ``rustfhe_tpu/engine/pallas_step.py``, the JAX engine
``"pallas"``: K4 replaces ``fused_cmux_step_merged`` (pallas_step.py:363),
K6 ``fused_cmux_step`` (pallas_step.py:267) and K5
``fused_external_product`` (pallas_step.py:158).  The kernels are CUDA C++
for sm_90a in ``csrc/limb_step.cu`` (with ``csrc/cmux_step.cuh`` and
``csrc/hopper_common.cuh``), built with nvcc
into a shared library with a plain C interface on first use (``build``)
and called through ctypes.  They read the step's doubled int8 limb table
of ``plain.prepare_trgsw_limbs``, (2L, 2, 4, 2N).

K4 and K6 are K1's step (``cmux_k``) on the limb table: one int8
tensor-core (``wgmma``) GEMM in three launches from one call, the step's
limb panels (``limb_panel``: K1's key panels, cut from the table's bytes),
the digits (K1's digit kernel) and the product with the limb recombination
and the add in its epilogue (K4's: ``merged_product``; K6's is K1's).
K4's block tile holds both output halves (2 halves x 4 limbs x 32
coefficients), K6's one half (4 limbs x 64 coefficients, K1's tile).  Each thread keeps its digit and
panel buffers per device and stream while their shapes hold
(``cmux_k._step_buffer``); the library keeps their TMA maps by address.
They take N a power of two in [8, 2048] with any l whose sums stay exact
(``check_bound`` and ``cmux_k.check_shape``).  K5 is to K4/K6 what K2 is
to K1: the limb panel and the product without the add, on the caller's
digits (two launches, no digit kernel), in K1's and K6's tile, at the
same shapes.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain torch version beside it, a CUDA tensor launches the
kernel or raises.  ``cmux_step_merged.launches`` and
``cmux_step_split.launches`` count steps (three kernel launches each),
``external_product.launches`` K5's calls (two launches each); nothing
else counts.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import poly
from .._u32 import wrap
from ..params import TFHEParams
from . import build, cmux_k, plain
from .cmux_k import SLICE, _check_tensor, _dispatch
from .plain import NUM_LIMBS

MERGED_COEFFS = cmux_k.COEFFS // 2  # coefficients of one limb in K4's block tile


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the library of ``csrc/limb_step.cu``.
    Raises RuntimeError when no CUDA device is available."""
    lib = build.load("limb_step")
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    step = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cu, vp]
    for name, args in (("rustfhe_limb_cmux_step_merged", step),
                       ("rustfhe_limb_cmux_step_split", step),
                       ("rustfhe_limb_panel", [vp, vp, ci, ci, vp]),
                       ("rustfhe_limb_merged_product", [vp, vp, vp, vp, ci, ci, ci, vp]),
                       ("rustfhe_limb_external_product", [vp, vp, vp, vp, ci, ci, ci, vp]),
                       ("rustfhe_limb_smem_optin", [ctypes.POINTER(ci)])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ci
    return lib


def _check(err: int, what: str) -> None:
    cmux_k._check(cmux_k.load_library(), err, what)


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """The card's opt-in limit of shared memory per block, in bytes."""
    lib = load_library()
    num = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check(lib.rustfhe_limb_smem_optin(ctypes.byref(num)), "shared-memory limit query")
    return num.value


def check_bound(params: TFHEParams) -> None:
    """Raise unless every per-limb plane sum, 2L*N * half_bg * 2^7 at most,
    stays below 2^31: the domain of the JAX engine, whose int8 products
    accumulate in int32 before the limbs recombine."""
    bound = 2 * params.l * params.N * params.half_bg * 128
    if bound >= 1 << 31:
        raise ValueError(f"per-limb sums reach 2L*N*half_bg*128 = {bound} >= 2^31 at "
                         f"N={params.N}, l={params.l}, bgbit={params.bgbit}: outside the "
                         "limb engine's exact int32 range")


def _check_step(acc, a_tilde, table, params: TFHEParams) -> None:
    B = acc.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    _check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    _check_tensor("table", table, torch.int8, (two_l, 2, NUM_LIMBS, 2 * N), acc.device)
    check_bound(params)


# --------------------------------------------------------------------- #
# K4 and K6: one blind-rotate CMux step in limb form
# --------------------------------------------------------------------- #
def cmux_step_plain(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """The plain version of K4 and K6: acc + ExtProd(key, Decompose(X^{a~}
    * acc - acc)), rotate (gather), difference, decomposition, then
    ``plain.external_product_limbs``."""
    from ..trgsw import decompose_trlwe

    rot = poly.rotate(acc, a_tilde[:, None])
    digits = decompose_trlwe(rot - acc, params).to(torch.int8)
    return acc + plain.external_product_limbs(digits, table)


def _step(entry: str, acc, a_tilde, table, params: TFHEParams) -> torch.Tensor:
    """The three launches of K4 or K6 (``entry``) into the calling thread's
    digit and panel buffers (``cmux_k._step_buffer``)."""
    B = acc.shape[0]
    N, two_l = params.N, 2 * params.l
    cmux_k.check_shape(N, two_l)
    if table.data_ptr() % 4:  # the panel kernel reads the table as words
        table = table.clone()
    stream = cmux_k._stream(acc.device)
    digits = cmux_k._step_buffer("digits", (B, two_l, cmux_k.geometry(N)[0]), acc.device, stream)
    panel = cmux_k._step_buffer("panel", cmux_k.panel_shape(params), acc.device, stream)
    out = torch.empty_like(acc)
    cmux_k._launch(entry, getattr(load_library(), entry), acc, a_tilde, table, out, digits, panel,
                   B, N, params.l, params.bgbit, params.decomp_mask, stream=stream)
    return out


def cmux_step_merged(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """K4, both output halves per block tile: ``acc`` int32 (B, 2, N),
    ``a_tilde`` int32 (B,) in [0, 2N), ``table`` the step's doubled limb
    table int8 (2L, 2, 4, 2N).  Returns the new accumulator."""
    _check_step(acc, a_tilde, table, params)
    if not _dispatch(acc.device):
        return cmux_step_plain(acc, a_tilde, table, params)
    out = _step("rustfhe_limb_cmux_step_merged", acc, a_tilde, table, params)
    cmux_step_merged.launches += 1
    return out


def cmux_step_split(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """K6, one output half per block tile; the operands and the result of
    ``cmux_step_merged``."""
    _check_step(acc, a_tilde, table, params)
    if not _dispatch(acc.device):
        return cmux_step_plain(acc, a_tilde, table, params)
    out = _step("rustfhe_limb_cmux_step_split", acc, a_tilde, table, params)
    cmux_step_split.launches += 1
    return out


cmux_step_merged.launches = 0
cmux_step_split.launches = 0


# --------------------------------------------------------------------- #
# K5: external product of precomputed digits
# --------------------------------------------------------------------- #
# K5's plain version: the limb-by-limb float64 products of engine/plain.py.
external_product_plain = plain.external_product_limbs


def external_product(digits: torch.Tensor, table: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """ExtProd(rows, digits): ``digits`` int8 (B, 2L, N) against the doubled
    limb table ``table`` int8 (2L, 2, 4, 2N).  Returns int32 (B, 2, N).

    On the card, K5's two launches: the limb panel into the calling
    thread's panel buffer (``cmux_k._step_buffer``), then the product of
    ``digits`` without the add, in K1's tile.  The digits go to TMA as they
    are when N is a multiple of SLICE (the limb engine's shapes),
    zero-padded to one slice below it."""
    B = digits.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("digits", digits, torch.int8, (B, two_l, N), digits.device)
    _check_tensor("table", table, torch.int8, (two_l, 2, NUM_LIMBS, 2 * N), digits.device)
    check_bound(params)
    if not _dispatch(digits.device):
        return external_product_plain(digits, table)
    cmux_k.check_shape(N, two_l)
    npad = cmux_k.geometry(N)[0]
    if npad != N:  # the product reads whole 128-byte slices: zeros past N
        digits = F.pad(digits, (0, npad - N))
    elif digits.data_ptr() % 16:
        raise ValueError("digits must start on a 16-byte boundary (TMA reads them in place)")
    if table.data_ptr() % 4:  # the panel kernel reads the table as words
        table = table.clone()
    stream = cmux_k._stream(digits.device)
    panel = cmux_k._step_buffer("panel", cmux_k.panel_shape(params), digits.device, stream)
    out = torch.empty((B, 2, N), dtype=torch.int32, device=digits.device)
    cmux_k._launch("limb_external_product", load_library().rustfhe_limb_external_product,
                   digits, table, out, panel, B, N, two_l, stream=stream)
    external_product.launches += 1
    return out


external_product.launches = 0


# --------------------------------------------------------------------- #
# The pieces of K4/K6 that are not K1's: their checks
# --------------------------------------------------------------------- #
def limb_panel_plain(table: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """The step's panels from its limb table ``table`` int8 (2L, 2, 4, 2N):
    int8 (2L, 2, 4, rows, SLICE) with

      panel[j, c, t, x - x0, r] = table[j, c, t, x - r]   (r < N, x < 2N)

    and zeros elsewhere: ``cmux_k.key_panel_plain`` of the int32 table
    whose limbs ``table`` holds."""
    N = params.N
    _, x0, rows = cmux_k.geometry(N)
    x = torch.arange(rows, device=table.device) + x0
    r = torch.arange(SLICE, device=table.device)
    live = (r[None, :] < N) & (x[:, None] < 2 * N)
    bytes_ = table[..., (x[:, None] - r[None, :]).clamp(0, 2 * N - 1)]  # (2L, 2, 4, rows, SLICE)
    return torch.where(live, bytes_, torch.zeros_like(bytes_)).contiguous()


def limb_panel(table: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """The panels of ``table`` (``limb_panel_plain``'s function), on the
    table's device."""
    N, two_l = params.N, 2 * params.l
    _check_tensor("table", table, torch.int8, (two_l, 2, NUM_LIMBS, 2 * N), table.device)
    if not _dispatch(table.device):
        return limb_panel_plain(table, params)
    cmux_k.check_shape(N, two_l)
    if table.data_ptr() % 4:
        table = table.clone()
    panel = torch.empty(cmux_k.panel_shape(params), dtype=torch.int8, device=table.device)
    cmux_k._launch("limb_panel", load_library().rustfhe_limb_panel, table, panel, N, two_l)
    return panel


def merged_product_plain(digits: torch.Tensor, panel: torch.Tensor, acc: torch.Tensor,
                         params: TFHEParams) -> torch.Tensor:
    """K4's product as its block tile computes it: per tile of
    ``MERGED_COEFFS`` coefficients k0 + kk, the stage's eight boxes (half c,
    limb t), panel rows k0 + kk + N - SLICE kb - x0 of plane j, give the
    tile's 256 columns 128c + 32t + kk; their int32 sums (float64, exact:
    below 2^31) over every plane and slice are read back at the column
    blocks 16c + 4t + kk // 8, recombined as sum_t << 8t mod 2^32 and added
    to ``acc``.  ``digits`` int8 (B, 2L, npad); ``panel`` as
    ``limb_panel``; returns int32 (B, 2, N)."""
    N = params.N
    npad, x0, _ = cmux_k.geometry(N)
    B, two_l = digits.shape[0], digits.shape[1]
    d = digits.to(torch.float64)
    kk = torch.arange(MERGED_COEFFS, device=digits.device)
    out = torch.empty((B, 2, N), dtype=torch.int64, device=digits.device)
    for k0 in range(0, N, MERGED_COEFFS):
        frag = torch.zeros((B, 2 * NUM_LIMBS * MERGED_COEFFS), dtype=torch.float64,
                           device=digits.device)
        for j in range(two_l):
            for kb in range(npad // SLICE):
                stage = panel[j].index_select(2, k0 + kk + N - SLICE * kb - x0)  # (2, 4, 32, SLICE)
                frag += d[:, j, SLICE * kb: SLICE * (kb + 1)] @ \
                    stage.reshape(-1, SLICE).to(torch.float64).t()
        # column 128c + 32t + kk: fragment block 16c + 4t + kk // 8
        part = frag.to(torch.int64).reshape(B, 2, NUM_LIMBS, MERGED_COEFFS)
        width = min(MERGED_COEFFS, N - k0)
        out[:, :, k0: k0 + width] = sum(part[:, :, t, :width] << (8 * t) for t in range(NUM_LIMBS))
    return acc + wrap(out)


def merged_product(digits: torch.Tensor, panel: torch.Tensor, acc: torch.Tensor,
                   params: TFHEParams) -> torch.Tensor:
    """K4's product (``merged_product_plain``'s function) on the device of
    ``digits``; K6's product is K1's (``cmux_k.panel_product``)."""
    B = digits.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("digits", digits, torch.int8, (B, two_l, cmux_k.geometry(N)[0]), digits.device)
    _check_tensor("panel", panel, torch.int8, cmux_k.panel_shape(params), digits.device)
    _check_tensor("acc", acc, torch.int32, (B, 2, N), digits.device)
    if not _dispatch(digits.device):
        return merged_product_plain(digits, panel, acc, params)
    cmux_k.check_shape(N, two_l)
    out = torch.empty_like(acc)
    cmux_k._launch("limb_merged_product", load_library().rustfhe_limb_merged_product, digits,
                   panel, acc, out, B, N, two_l)
    return out


def reset_counters() -> None:
    cmux_step_merged.launches = 0
    cmux_step_split.launches = 0
    external_product.launches = 0
