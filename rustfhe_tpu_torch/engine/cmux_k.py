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
``cmux_rotate`` issues a whole rotation's steps from one call into the
library, which launches them in a C loop.

At ``KARATSUBA_MIN_ROWS`` rows or more (per parameter set, measured on the
card) ``cmux_rotate`` takes the same step on the two-level Karatsuba
product instead (``cmux_step_karatsuba``, ``csrc/karatsuba_step.cuh``): the
nine leaf products of ``engine/karatsuba.py`` at 9/16 of the schoolbook
multiply-adds, combined in the product's epilogue, on each step's leaf
table (``leaf_table``, prepared once for the whole key), every output word
the same.  ``product_for`` says which product a rotation of B rows takes.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain torch version beside it, a CUDA tensor launches the
kernel or raises.  There is no fallback from a failed launch to the plain
version.  ``cmux_step.launches`` counts steps (three kernel launches each),
``cmux_rotate``'s among them, ``cmux_rotate.launches`` the rotations issued
in one call, ``cmux_step_karatsuba.launches`` the steps among them on the
Karatsuba product, ``cmux_step_panel.launches`` steps on a prebuilt panel (two
each: the digits and the product), ``external_product.launches`` K2's
calls (two each) and ``key_panel.launches`` the panel kernel launched alone
(a hybrid key's build); nothing else counts.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref

import torch
import torch.nn.functional as F

from .. import poly
from .._u32 import wrap
from ..params import TFHEParams
from ..utils import trace
from . import build, karatsuba, plain

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
    pi = ctypes.POINTER(ctypes.c_int)
    for name, args in (
            ("rustfhe_cmux_step_k", [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cu, vp]),
            ("rustfhe_cmux_rotate_k", [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cu, pi, pi,
                                       vp]),
            ("rustfhe_cmux_rotate_karatsuba", [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cu,
                                               pi, pi, vp]),
            ("rustfhe_cmux_step_karatsuba", [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cu, vp]),
            ("rustfhe_cmux_step_panel", [vp, vp, vp, vp, vp, ci, ci, ci, ci, cu, vp]),
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


def cmux_rotate(acc: torch.Tensor, a_steps: torch.Tensor, key: torch.Tensor,
                params: TFHEParams, span=trace.OFF) -> torch.Tensor:
    """The n steps of a blind rotation, ``cmux_step`` on ``a_steps[i]`` and
    ``key[i]`` for i < n, from one host call: ``acc`` int32 (B, 2, N),
    ``a_steps`` int32 (n, B) (``bootstrap.rotation_start``), ``key`` the
    prepared key int32 (n, 2L, 2, 2N).  On the card the library runs the
    steps' launches in a C loop on the current stream, alternating between
    ``acc`` and one new accumulator, so ``acc`` is overwritten; the result
    is whichever of the two the last step wrote.  The kernels, their order
    and their inputs are ``cmux_step``'s, so every output word is the same.
    Adds n to ``cmux_step.launches`` and 1 to ``cmux_rotate.launches``.  On
    the CPU: n calls of ``cmux_step``, that is the loop of
    ``cmux_step_plain``, ``acc`` left as it was.

    Where ``product_for`` says "karatsuba" (a batch of at least
    ``KARATSUBA_MIN_ROWS`` rows) the steps are ``cmux_step_karatsuba``'s on
    the key's ``leaf_table``, in the same one call (on the CPU the loop of
    its plain version), every output word the same; they also count in
    ``cmux_step_karatsuba.launches``.  ``span`` (the caller's open
    ``trace.span``) gets the product taken as its ``product`` attribute."""
    B, n = acc.shape[0], params.n
    N, two_l = params.N, 2 * params.l
    _check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    _check_tensor("a_steps", a_steps, torch.int32, (n, B), acc.device)
    _check_tensor("key", key, torch.int32, (n, two_l, 2, 2 * N), acc.device)
    product = product_for(params, B)
    span.set(product=product)
    if product == "karatsuba":
        return _rotate_karatsuba(acc, a_steps, leaf_table(key, params), params)
    return _rotate_schoolbook(acc, a_steps, key, params)


def _rotate_schoolbook(acc: torch.Tensor, a_steps: torch.Tensor, key: torch.Tensor,
                       params: TFHEParams) -> torch.Tensor:
    """``cmux_rotate`` on ``cmux_step``'s schoolbook steps."""
    if not _dispatch(acc.device):
        for i in range(params.n):  # cmux_step_plain through the step's own dispatch
            acc = cmux_step(acc, a_steps[i], key[i], params)
        return acc
    check_shape(params.N, 2 * params.l)
    stream = _stream(acc.device)
    digits = _step_buffer("digits", (acc.shape[0], 2 * params.l, geometry(params.N)[0]),
                          acc.device, stream)
    panel = _step_buffer("panel", panel_shape(params), acc.device, stream)
    return _rotate_call("cmux_rotate_k", acc, a_steps, key, digits, panel, params, stream)


def _rotate_call(what: str, acc: torch.Tensor, a_steps: torch.Tensor, key: torch.Tensor,
                 digits: torch.Tensor, panel: torch.Tensor, params: TFHEParams,
                 stream: int) -> torch.Tensor:
    """One call of the library's rotation ``rustfhe_<what>`` (the schoolbook
    or the Karatsuba steps) on ``key`` (the doubled tables or the leaf
    tables), ``acc`` and one new accumulator; returns whichever the last
    step wrote and counts the steps and the rotation."""
    B, n = acc.shape[0], params.n
    other = torch.empty_like(acc)
    failed, result = ctypes.c_int(-1), ctypes.c_int(0)
    lib = load_library()
    with torch.cuda.device(acc.device):
        err = getattr(lib, "rustfhe_" + what)(
            acc.data_ptr(), a_steps.data_ptr(), key.data_ptr(), other.data_ptr(),
            digits.data_ptr(), panel.data_ptr(), n, B, params.N, params.l, params.bgbit,
            params.decomp_mask, ctypes.byref(failed), ctypes.byref(result), stream)
    _check(lib, err, f"{what} (step {failed.value} of {n})")
    cmux_step.launches += n
    cmux_rotate.launches += 1
    return other if result.value else acc


cmux_rotate.launches = 0


# --------------------------------------------------------------------- #
# K1 on the two-level Karatsuba product: the wide batches' step
# --------------------------------------------------------------------- #
SPAN = 32  # leaf positions of the Karatsuba product's block tile (csrc/karatsuba_step.cuh)

# The fewest rows at which the Karatsuba step is faster than the schoolbook
# one, per (N, l, bgbit), from the two steps timed in turns on the card
# (``benches/karatsuba_crossover.py``, PERF.md §6): DEFAULT_PARAMS and
# PBS_PARAMS.  A parameter set not here keeps the schoolbook step.
KARATSUBA_MIN_ROWS = {(1024, 3, 6): 768, (2048, 4, 6): 512}


def karatsuba_takes(params: TFHEParams) -> bool:
    """True when the Karatsuba step takes ``params``: N a power of two in
    [4 SPAN, MAX_N] (whole block tiles of leaf positions) and the digit tree
    and leaf sums in range (``karatsuba.check_bound``)."""
    if not 4 * SPAN <= params.N <= MAX_N or params.N & (params.N - 1):
        return False
    try:
        karatsuba.check_bound(params)
    except ValueError:
        return False
    return True


def wants_leaf_table(params: TFHEParams) -> bool:
    """True when a K1 rotation at ``params`` takes the Karatsuba step from
    some batch on (``KARATSUBA_MIN_ROWS`` has a threshold for it), so that
    its key needs ``leaf_table``."""
    return ((params.N, params.l, params.bgbit) in KARATSUBA_MIN_ROWS
            and karatsuba_takes(params))


def product_for(params: TFHEParams, rows: int) -> str:
    """The product a K1 rotation of ``rows`` rows takes: "karatsuba" at
    ``KARATSUBA_MIN_ROWS`` or more for ``params``, else "schoolbook"."""
    if (wants_leaf_table(params)
            and rows >= KARATSUBA_MIN_ROWS[(params.N, params.l, params.bgbit)]):
        return "karatsuba"
    return "schoolbook"


_leaf_tables: dict = {}  # id(key) -> (the key's weak reference, its leaf tables)


def leaf_table(key: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """The leaf limb tables of every step of the prepared key ``key`` int32
    (n, 2L, 2, 2N): int8 (n, 2, 9, 4, 2L, N/2), ``karatsuba.prepare_table``
    of each step's rows (the upper half of its doubled table), on the key's
    device.  Built once for a key and kept while the key lives (``keys``
    builds a card key's in set-up)."""
    n, two_l, N = key.shape[0], 2 * params.l, params.N
    _check_tensor("key", key, torch.int32, (n, two_l, 2, 2 * N), key.device)
    hit = _leaf_tables.get(id(key))
    if hit is not None and hit[0]() is key:
        return hit[1]
    table = torch.empty((n,) + karatsuba.table_shape(params), dtype=torch.int8, device=key.device)
    for i in range(0, n, 64):  # a few steps at a time, to bound the temporaries
        table[i: i + 64] = karatsuba.prepare_table(key[i: i + 64, ..., N:])
    _leaf_tables[id(key)] = (weakref.ref(key), table)
    weakref.finalize(key, _leaf_tables.pop, id(key), None)
    return table


def cmux_step_karatsuba_plain(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                              params: TFHEParams) -> torch.Tensor:
    """``cmux_step_plain``'s function through the Karatsuba leaves: the
    residue layout's plain step (``karatsuba.step_plain``) on the step's
    leaf table, in and out of the standard layout."""
    flat = karatsuba.step_plain(karatsuba.scan_enter(acc), a_tilde, table, params)
    return karatsuba.scan_exit(flat)


def _check_karatsuba(params: TFHEParams) -> None:
    if not karatsuba_takes(params):
        raise ValueError(f"the Karatsuba step takes N a power of two in [{4 * SPAN}, {MAX_N}] "
                         f"with half_bg * 4 <= 128, got N={params.N}, bgbit={params.bgbit}")


def _karatsuba_buffers(B: int, params: TFHEParams, device: torch.device,
                       stream: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The calling thread's tree-digit and leaf-panel buffers of the
    Karatsuba step: int8 (B, 9, 2L, npad) and (9, 2L, 2, LIMBS, rows,
    SLICE) at ns = N/4."""
    npad, _, rows = geometry(params.N // karatsuba.R)
    two_l = 2 * params.l
    return (_step_buffer("leaf_digits", (B, karatsuba.T, two_l, npad), device, stream),
            _step_buffer("leaf_panel", (karatsuba.T, two_l, 2, LIMBS, rows, SLICE), device,
                         stream))


def cmux_step_karatsuba(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                        params: TFHEParams) -> torch.Tensor:
    """``cmux_step`` on the Karatsuba product: ``table`` the step's leaf
    table int8 (2, 9, 4, 2L, N/2) (a row of ``leaf_table``).  Three
    launches: the leaf panels, the tree digits and the product with the
    combine and the add in its epilogue."""
    B = acc.shape[0]
    N = params.N
    _check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    _check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    _check_tensor("table", table, torch.int8, karatsuba.table_shape(params), acc.device)
    _check_karatsuba(params)
    if not _dispatch(acc.device):
        return cmux_step_karatsuba_plain(acc, a_tilde, table, params)
    stream = _stream(acc.device)
    digits, panel = _karatsuba_buffers(B, params, acc.device, stream)
    out = torch.empty_like(acc)
    _launch("cmux_step_karatsuba", load_library().rustfhe_cmux_step_karatsuba, acc, a_tilde,
            table, out, digits, panel, B, N, params.l, params.bgbit, params.decomp_mask,
            stream=stream)
    cmux_step.launches += 1
    cmux_step_karatsuba.launches += 1
    return out


cmux_step_karatsuba.launches = 0


def _rotate_karatsuba(acc: torch.Tensor, a_steps: torch.Tensor, tables: torch.Tensor,
                      params: TFHEParams) -> torch.Tensor:
    """``cmux_rotate`` on the Karatsuba steps, ``tables`` the key's
    ``leaf_table``: on the card one call into the library's C loop
    (``rustfhe_cmux_rotate_karatsuba``), ``acc`` overwritten; on the CPU the
    loop of ``cmux_step_karatsuba_plain``."""
    _check_karatsuba(params)
    if not _dispatch(acc.device):
        for i in range(params.n):  # the plain step through the step's own dispatch
            acc = cmux_step_karatsuba(acc, a_steps[i], tables[i], params)
        return acc
    stream = _stream(acc.device)
    digits, panel = _karatsuba_buffers(acc.shape[0], params, acc.device, stream)
    out = _rotate_call("cmux_rotate_karatsuba", acc, a_steps, tables, digits, panel, params,
                       stream)
    cmux_step_karatsuba.launches += params.n
    return out


# --------------------------------------------------------------------- #
# K1 on a prebuilt panel: the hybrid key's steps (keys.cloud_key_hybrid)
# --------------------------------------------------------------------- #
def cmux_step_panel_plain(acc: torch.Tensor, a_tilde: torch.Tensor, panel: torch.Tensor,
                          params: TFHEParams) -> torch.Tensor:
    """``cmux_step_plain``'s function with the step's key given as its
    panels (``key_panel``): the digits, then the product from the panels
    (``panel_product_plain``)."""
    return panel_product_plain(step_digits_plain(acc, a_tilde, params), panel, acc, params)


def cmux_step_panel(acc: torch.Tensor, a_tilde: torch.Tensor, panel: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """One blind-rotate step on the step's prebuilt key panels ``panel``
    int8 (2L, 2, LIMBS, rows, SLICE) (``key_panel``): K1's digit and
    product kernels without its panel kernel, two launches.  The JAX
    package runs a hybrid key's pair of steps as one launch
    (``cmux_step_pair``, K1 with ``unroll=2``); here the odd step's digits
    read the whole accumulator that the even step's product tiles write
    across blocks, so a fused pair would need a grid-wide barrier to save
    one accumulator round trip, and the two steps stay two calls."""
    B = acc.shape[0]
    N, two_l = params.N, 2 * params.l
    _check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    _check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    _check_tensor("panel", panel, torch.int8, panel_shape(params), acc.device)
    if not _dispatch(acc.device):
        return cmux_step_panel_plain(acc, a_tilde, panel, params)
    check_shape(N, two_l)
    stream = _stream(acc.device)
    digits = _step_buffer("digits", (B, two_l, geometry(N)[0]), acc.device, stream)
    out = torch.empty_like(acc)
    _launch("cmux_step_panel", load_library().rustfhe_cmux_step_panel, acc, a_tilde, panel, out,
            digits, B, N, params.l, params.bgbit, params.decomp_mask, stream=stream)
    cmux_step_panel.launches += 1
    return out


cmux_step_panel.launches = 0


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


def key_panel(key: torch.Tensor, params: TFHEParams,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """The key panels of ``key`` (``key_panel_plain``'s function), on the
    key's device, into ``out`` when it is given (a hybrid key's slot)."""
    N, two_l = params.N, 2 * params.l
    _check_tensor("key", key, torch.int32, (two_l, 2, 2 * N), key.device)
    if out is not None:
        _check_tensor("out", out, torch.int8, panel_shape(params), key.device)
    if not _dispatch(key.device):
        panel = key_panel_plain(key, params)
        return panel if out is None else out.copy_(panel)
    check_shape(N, two_l)
    panel = torch.empty(panel_shape(params), dtype=torch.int8,
                        device=key.device) if out is None else out
    _launch("key_panel", load_library().rustfhe_key_panel, key, panel, N, two_l)
    key_panel.launches += 1
    return panel


key_panel.launches = 0


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
    for fn in (cmux_step, cmux_rotate, cmux_step_karatsuba, cmux_step_panel, external_product,
               key_panel):
        fn.launches = 0
