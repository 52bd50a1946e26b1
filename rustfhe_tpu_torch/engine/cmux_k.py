"""The blind-rotate CMux step (K1) and the external product (K2).

Counterpart of ``rustfhe_tpu/engine/pallas_k.py``: K1 replaces
``fused_cmux_step_k`` (pallas_k.py:295) and K2 ``fused_external_product_k``
(pallas_k.py:506).  The kernels are CUDA C++ for sm_90a in
``csrc/cmux_k.cu`` (with ``csrc/hopper_common.cuh`` and
``csrc/cmux_common.cuh``), built with nvcc into a shared library with a
plain C interface on first use (``build``) and called through ctypes.

A step is one int8 GEMM on the tensor cores (``wgmma``), in three
launches: the step's key panels (``key_panel``: the balanced int8 limbs of
the doubled key, one K-major row per output coefficient and 128-byte K
slice), the digits (``step_digits``: int8 (B, 2L, Npad), Npad = N rounded
up to 128) and the product with the limb recombination and the add in its
epilogue (``panel_product``).  K2 is the panel and the product of the
caller's digits.  Each thread keeps its own digit and panel buffers for
``cmux_step`` per device and stream while their shapes hold, across the
steps of a rotation; the library keeps their TMA maps by address.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain torch version beside it, a CUDA tensor launches the
kernel or raises.  There is no fallback from a failed launch to the plain
version.  ``cmux_step.launches`` counts steps (three kernel launches each)
and ``external_product.launches`` K2's calls (two each); nothing else
counts.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from .. import poly
from .._u32 import wrap
from ..params import TFHEParams
from . import build, plain

SLICE = 128  # bytes of K per stage of the product's TMA ring
LIMBS = 4  # balanced signed 8-bit limbs of a key word
COEFFS = 64  # output coefficients of one limb in a block tile: a panel box's rows
MIN_N, MAX_N = 8, 2048
# The product's shared memory at any shape (csrc/cmux_step.cuh SMEM): 1 KiB of
# alignment, a 4-stage ring of a 128 x SLICE digit box and four COEFFS x SLICE
# panel boxes, 8 barriers.
SMEM_BYTES = 1024 + 4 * (128 * SLICE + 4 * COEFFS * SLICE) + 8 * 8


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the library of ``csrc/cmux_k.cu``.
    Raises RuntimeError when no CUDA device is available."""
    lib = build.load("cmux_k")
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    for name, args in (
            ("rustfhe_cmux_step_k", [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cu, vp]),
            ("rustfhe_external_product_k", [vp, vp, vp, vp, ci, ci, ci, vp]),
            ("rustfhe_key_panel", [vp, vp, ci, ci, vp]),
            ("rustfhe_step_digits", [vp, vp, vp, ci, ci, ci, ci, cu, vp]),
            ("rustfhe_panel_product", [vp, vp, vp, vp, ci, ci, ci, vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ci
    lib.rustfhe_cuda_error_string.argtypes = [ci]
    lib.rustfhe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.rustfhe_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _dispatch(device: torch.device) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


# --------------------------------------------------------------------- #
# The step's shapes
# --------------------------------------------------------------------- #
def geometry(N: int) -> tuple[int, int, int]:
    """(npad, x0, rows) at ring degree N: the bytes of digits of a plane
    (N rounded up to SLICE), the key offset of a panel's first row, and the
    rows of one panel ([x0, 2N), at least one box of COEFFS)."""
    npad = max(N, SLICE)
    x0 = N + SLICE - npad
    return npad, x0, max(2 * N - x0, COEFFS)


def panel_shape(params: TFHEParams) -> tuple[int, ...]:
    """The key panels of one step: (2L, 2, LIMBS, rows, SLICE) int8."""
    return (2 * params.l, 2, LIMBS, geometry(params.N)[2], SLICE)


def check_shape(N: int, two_l: int) -> None:
    """Raise ValueError unless the kernels take ring degree N and 2L planes:
    N a power of two in [MIN_N, MAX_N], and every int32 sum of the product,
    2L * Npad * 128 * 128 at most for int8 digits, below 2^31."""
    if not MIN_N <= N <= MAX_N or N & (N - 1):
        raise ValueError(f"the CMux kernels take N a power of two in [{MIN_N}, {MAX_N}], got {N}")
    bound = two_l * geometry(N)[0] * 128 * 128
    if bound >= 1 << 31:
        raise ValueError(f"int8 sums reach 2L*Npad*128*128 = {bound} >= 2^31: outside the "
                         "exact int32 range")


def _launch(what: str, fn, *args, stream: int | None = None) -> None:
    """Call ``fn(*args, stream)`` with the first tensor's device current,
    tensors passed by address, on ``stream`` or that device's current
    stream, and raise on an error."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(device):
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                 _stream(device) if stream is None else stream)
    _check(load_library(), err, what)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_scratch = threading.local()  # each thread's step buffers, {(device, stream, role): tensor}


def _step_buffer(role: str, shape: tuple[int, ...], device: torch.device,
                 stream: int) -> torch.Tensor:
    """The calling thread's int8 ``role`` buffer ("digits" or "panel") for
    steps on ``stream``, kept while its shape holds.  Steps on one stream
    run in order, so a step never overwrites a buffer that an earlier step
    still reads, and no other thread's step writes it.  Two allocations
    per step made the host-bound K1 loop at B <= 32 8-25 % slower
    (PERF.md §6)."""
    bufs = _scratch.__dict__.setdefault("bufs", {})
    buf = bufs.get((device, stream, role))
    if buf is None or tuple(buf.shape) != shape:
        buf = bufs[device, stream, role] = torch.empty(shape, dtype=torch.int8, device=device)
    return buf


# --------------------------------------------------------------------- #
# K1: one blind-rotate CMux step
# --------------------------------------------------------------------- #
def cmux_step_plain(acc: torch.Tensor, a_tilde: torch.Tensor, key: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """acc + ExtProd(key, Decompose(X^{a~} * acc - acc)): rotate (gather),
    difference, decomposition, then ``plain.external_product``."""
    from ..trgsw import decompose_trlwe

    rot = poly.rotate(acc, a_tilde[:, None])
    digits = decompose_trlwe(rot - acc, params).to(torch.int8)
    return acc + plain.external_product(digits, key)


def cmux_step(acc: torch.Tensor, a_tilde: torch.Tensor, key: torch.Tensor,
              params: TFHEParams) -> torch.Tensor:
    """One blind-rotate step for a batch: ``acc`` int32 (B, 2, N), ``a_tilde``
    int32 (B,) in [0, 2N), ``key`` the step's doubled TRGSW table int32
    (2L, 2, 2N) (``plain.prepare_trgsw``).  Returns the new accumulator."""
    B = acc.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    _check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    _check_tensor("key", key, torch.int32, (two_l, 2, 2 * N), acc.device)
    if not _dispatch(acc.device):
        return cmux_step_plain(acc, a_tilde, key, params)
    check_shape(N, two_l)
    stream = _stream(acc.device)
    digits = _step_buffer("digits", (B, two_l, geometry(N)[0]), acc.device, stream)
    panel = _step_buffer("panel", panel_shape(params), acc.device, stream)
    out = torch.empty_like(acc)
    _launch("cmux_step_k", load_library().rustfhe_cmux_step_k, acc, a_tilde, key, out, digits,
            panel, B, N, params.l, params.bgbit, params.decomp_mask, stream=stream)
    cmux_step.launches += 1
    return out


cmux_step.launches = 0


# --------------------------------------------------------------------- #
# K2: external product of precomputed digits
# --------------------------------------------------------------------- #
# K2's plain version: the float64 GEMM of engine/plain.py.
external_product_plain = plain.external_product


def external_product(digits: torch.Tensor, key: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """ExtProd(rows, digits): ``digits`` int8 (B, 2L, N) against the doubled
    TRGSW table ``key`` int32 (2L, 2, 2N).  Returns int32 (B, 2, N)."""
    B = digits.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("digits", digits, torch.int8, (B, two_l, N), digits.device)
    _check_tensor("key", key, torch.int32, (two_l, 2, 2 * N), digits.device)
    if not _dispatch(digits.device):
        return external_product_plain(digits, key)
    check_shape(N, two_l)
    npad = geometry(N)[0]
    if npad != N:  # the product reads whole 128-byte slices: zeros past N
        digits = F.pad(digits, (0, npad - N))
    elif digits.data_ptr() % 16:  # TMA reads from a 16-byte boundary
        digits = digits.clone()
    panel = torch.empty(panel_shape(params), dtype=torch.int8, device=digits.device)
    out = torch.empty((B, 2, N), dtype=torch.int32, device=digits.device)
    _launch("external_product_k", load_library().rustfhe_external_product_k, digits, key, out,
            panel, B, N, two_l)
    external_product.launches += 1
    return out


external_product.launches = 0


# --------------------------------------------------------------------- #
# The pieces of a step, alone: their checks and times
# --------------------------------------------------------------------- #
def key_panel_plain(key: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """The key panels of a step from its doubled table ``key`` int32 (2L, 2,
    2N): int8 (2L, 2, LIMBS, rows, SLICE) with

      panel[j, c, t, x - x0, r] = limb_t(key[j, c, x - r])   (r < N, x < 2N)

    and zeros elsewhere; limb_t is ``poly.to_signed_limbs``'s split."""
    N = params.N
    _, x0, rows = geometry(N)
    x = torch.arange(rows, device=key.device) + x0
    r = torch.arange(SLICE, device=key.device)
    live = (r[None, :] < N) & (x[:, None] < 2 * N)
    words = key[..., (x[:, None] - r[None, :]).clamp(0, 2 * N - 1)]  # (2L, 2, rows, SLICE)
    words = torch.where(live, words, torch.zeros_like(words))
    limbs = poly.to_signed_limbs(words, 8, LIMBS)  # (..., rows, SLICE, LIMBS)
    return limbs.permute(0, 1, 4, 2, 3).contiguous()


def key_panel(key: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """The key panels of ``key`` (``key_panel_plain``'s function), on the
    key's device."""
    N, two_l = params.N, 2 * params.l
    _check_tensor("key", key, torch.int32, (two_l, 2, 2 * N), key.device)
    if not _dispatch(key.device):
        return key_panel_plain(key, params)
    check_shape(N, two_l)
    panel = torch.empty(panel_shape(params), dtype=torch.int8, device=key.device)
    _launch("key_panel", load_library().rustfhe_key_panel, key, panel, N, two_l)
    return panel


def step_digits_plain(acc: torch.Tensor, a_tilde: torch.Tensor,
                      params: TFHEParams) -> torch.Tensor:
    """The digits of X^{a~} * acc - acc as int8 (B, 2L, npad), plane p*l + lv
    as ``trgsw.decompose_trlwe`` orders them, zeros past N."""
    from ..trgsw import decompose_trlwe

    diff = poly.rotate(acc, a_tilde[:, None]) - acc
    digits = decompose_trlwe(diff, params).to(torch.int8)
    return F.pad(digits, (0, geometry(params.N)[0] - params.N)).contiguous()


def step_digits(acc: torch.Tensor, a_tilde: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """``step_digits_plain``'s function on the device of ``acc``."""
    B = acc.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    _check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    if not _dispatch(acc.device):
        return step_digits_plain(acc, a_tilde, params)
    check_shape(N, two_l)
    digits = torch.empty((B, two_l, geometry(N)[0]), dtype=torch.int8, device=acc.device)
    _launch("step_digits", load_library().rustfhe_step_digits, acc, a_tilde, digits, B, N,
            params.l, params.bgbit, params.decomp_mask)
    return digits


def panel_parts_plain(digits: torch.Tensor, panel: torch.Tensor, N: int) -> torch.Tensor:
    """The product's int32 sums per (half, limb) as the kernel forms them,
    from the panels, before the recombination: for each plane j and
    128-byte slice kb, the digits of the slice against panel rows k + N -
    128 kb - x0 (float64, exact: below 2^31).  ``digits`` int8 (B, 2L,
    npad); ``panel`` as ``key_panel``; returns int64 (B, 2, LIMBS, N)."""
    npad, x0, _ = geometry(N)
    B, two_l = digits.shape[0], digits.shape[1]
    k = torch.arange(N, device=digits.device)
    d = digits.to(torch.float64)
    parts = torch.zeros((B, 2, LIMBS, N), dtype=torch.float64, device=digits.device)
    for j in range(two_l):
        for kb in range(npad // SLICE):
            # (2, LIMBS, N, SLICE): the key tile of every coefficient over slice kb
            w = panel[j].index_select(2, k + N - SLICE * kb - x0).to(torch.float64)
            parts += torch.einsum("br,ctkr->bctk", d[:, j, SLICE * kb: SLICE * (kb + 1)], w)
    return parts.to(torch.int64)


def panel_product_plain(digits: torch.Tensor, panel: torch.Tensor, acc: torch.Tensor | None,
                        params: TFHEParams) -> torch.Tensor:
    """The product as the kernel computes it, from the panels: the sums of
    ``panel_parts_plain``, then sum_t << 8t mod 2^32, plus ``acc`` unless it
    is None (K2's function).  ``digits`` int8 (B, 2L, npad); ``panel`` as
    ``key_panel``; returns int32 (B, 2, N)."""
    parts = panel_parts_plain(digits, panel, params.N)
    out = wrap(sum(parts[:, :, t] << (8 * t) for t in range(LIMBS)))
    return out if acc is None else acc + out


def panel_product(digits: torch.Tensor, panel: torch.Tensor, acc: torch.Tensor,
                  params: TFHEParams) -> torch.Tensor:
    """K1's product, ``acc`` plus ``panel_product_plain``'s product, on the
    device of ``digits``."""
    B = digits.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("digits", digits, torch.int8, (B, two_l, geometry(N)[0]), digits.device)
    _check_tensor("panel", panel, torch.int8, panel_shape(params), digits.device)
    _check_tensor("acc", acc, torch.int32, (B, 2, N), digits.device)
    if not _dispatch(digits.device):
        return panel_product_plain(digits, panel, acc, params)
    check_shape(N, two_l)
    out = torch.empty_like(acc)
    _launch("panel_product", load_library().rustfhe_panel_product, digits, panel, acc, out,
            B, N, two_l)
    return out


def reset_counters() -> None:
    for fn in (cmux_step, external_product):
        fn.launches = 0
