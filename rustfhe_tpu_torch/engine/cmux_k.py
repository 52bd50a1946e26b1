"""The blind-rotate CMux step (K1) and the external product (K2).

Counterpart of ``rustfhe_tpu/engine/pallas_k.py``: K1 replaces
``fused_cmux_step_k`` (pallas_k.py:295) and K2 ``fused_external_product_k``
(pallas_k.py:506).  The kernels are CUDA C++ for sm_90a in
``csrc/cmux_k.cu`` (with ``csrc/hopper_common.cuh`` and
``csrc/cmux_common.cuh``), built with nvcc into a shared library with a
plain C interface on first use (``build``) and called through ctypes
(``launch``).

A step is one int8 GEMM on the tensor cores (``wgmma``), in three
launches: the step's key panels (``key_panel``: the balanced int8 limbs of
the doubled key, one K-major row per output coefficient and 128-byte K
slice), the digits (``step_digits``: int8 (B, 2L, Npad), Npad = N rounded
up to 128) and the product with the limb recombination and the add in its
epilogue (``panel_product``).  K2 is the panel and the product of the
caller's digits.  Each thread keeps its own digit and panel buffers for
K1's steps per device and stream while their shapes hold, across the
steps of a rotation (``step_buffers``); the library keeps their TMA maps by
address.  ``rotate`` issues a rotation's steps on the product it is given
from one call into the library's rotation entry for that product, which
launches them in a C loop; ``cmux_step`` is a rotation of one step.

At ``KARATSUBA_MIN_ROWS`` rows or more (per parameter set, measured on the
card) ``cmux_rotate`` takes the same step on the two-level Karatsuba
product instead (``cmux_step_karatsuba``, ``csrc/karatsuba_step.cuh``): the
nine leaf products of ``engine/karatsuba.py`` at 9/16 of the schoolbook
multiply-adds, written out as the step's leaves and added back by a
combine launch (``leaf_combine``), on each step's leaf table
(``leaf_table``, prepared once for the whole key), every output word the
same.  ``product_for`` says which product a rotation of B rows takes.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain torch version beside it, a CUDA tensor launches the
kernel or raises.  There is no fallback from a failed launch to the plain
version.  ``cmux_step.launches`` counts K1's steps (three kernel launches
each, four on the Karatsuba product), a single step's and every
rotation's, ``cmux_rotate.launches`` the ``cmux_rotate`` calls,
``cmux_step_karatsuba.launches`` the steps on the
Karatsuba product, ``cmux_step_panel.launches`` steps on a prebuilt panel (two
each: the digits and the product), ``external_product.launches`` K2's
calls (two each) and ``key_panel.launches`` the panel kernel launched alone
(a hybrid key's build); nothing else counts.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch
import torch.nn.functional as F

from .. import poly
from .._u32 import wrap
from ..params import TFHEParams
from ..utils import trace
from . import karatsuba, launch, plain
from .launch import INT, INT_P, UINT, VP, check_tensor, dispatch

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
    counts = [INT, INT, INT, INT, INT, UINT, INT_P, INT_P, VP]  # n, B, N, l, bgbit, mask, ...
    return launch.bind("cmux_k", {
        "rustfhe_cmux_rotate_k": [VP] * 6 + counts,
        "rustfhe_cmux_rotate_karatsuba": [VP] * 7 + counts,
        "rustfhe_leaf_combine": [VP, VP, VP, INT, INT, INT, INT, VP],
        "rustfhe_cmux_step_panel": [VP, VP, VP, VP, VP, INT, INT, INT, INT, UINT, VP],
        "rustfhe_external_product_k": [VP, VP, VP, VP, INT, INT, INT, VP],
        "rustfhe_key_panel": [VP, VP, INT, INT, VP],
        "rustfhe_step_digits": [VP, VP, VP, INT, INT, INT, INT, UINT, VP],
        "rustfhe_panel_product": [VP, VP, VP, VP, INT, INT, INT, VP]})


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


# --------------------------------------------------------------------- #
# K1: one blind-rotate CMux step
# --------------------------------------------------------------------- #
def cmux_step_plain(acc: torch.Tensor, a_tilde: torch.Tensor, key: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """acc + ExtProd(key, Decompose(X^{a~} * acc - acc)): ``plain.cmux_step``
    on ``plain.external_product``."""
    return plain.cmux_step(acc, a_tilde, params, lambda d: plain.external_product(d, key))


def cmux_step(acc: torch.Tensor, a_tilde: torch.Tensor, key: torch.Tensor,
              params: TFHEParams) -> torch.Tensor:
    """One blind-rotate step for a batch: ``acc`` int32 (B, 2, N), ``a_tilde``
    int32 (B,) in [0, 2N), ``key`` the step's doubled TRGSW table int32
    (2L, 2, 2N) (``plain.prepare_trgsw``).  Returns the new accumulator; on
    the card ``rotate`` of this one step, ``acc`` not written."""
    B = acc.shape[0]
    N, two_l = params.N, 2 * params.l
    check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    check_tensor("key", key, torch.int32, (two_l, 2, 2 * N), acc.device)
    if not dispatch(acc.device):
        return cmux_step_plain(acc, a_tilde, key, params)
    return rotate(acc, a_tilde[None], key[None], params, "schoolbook")


cmux_step.launches = 0


# --------------------------------------------------------------------- #
# K1 on the two-level Karatsuba product: the wide batches' step
# --------------------------------------------------------------------- #
# The fewest rows at which the Karatsuba step is faster than the schoolbook
# one, per (N, l, bgbit), from the two steps timed in turns on the card
# (``benches/karatsuba_crossover.py``, PERF.md §6): DEFAULT_PARAMS and
# PBS_PARAMS, where the schoolbook product's tiles first outgrow one wave
# of the card's SMs.  A parameter set not here keeps the schoolbook step.
KARATSUBA_MIN_ROWS = {(1024, 3, 6): 576, (2048, 4, 6): 320}


def karatsuba_takes(params: TFHEParams) -> bool:
    """True when the Karatsuba step takes ``params``: N a power of two in
    [R MIN_N, MAX_N] (the leaf product is K1's at ring degree N/R) and the
    digit tree and leaf sums in range (``karatsuba.check_bound``)."""
    if not karatsuba.R * MIN_N <= params.N <= MAX_N or params.N & (params.N - 1):
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
    check_tensor("key", key, torch.int32, (n, two_l, 2, 2 * N), key.device)
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
        raise ValueError(f"the Karatsuba step takes N a power of two in "
                         f"[{karatsuba.R * MIN_N}, {MAX_N}] "
                         f"with half_bg * 4 <= 128, got N={params.N}, bgbit={params.bgbit}")


def cmux_step_karatsuba(acc: torch.Tensor, a_tilde: torch.Tensor, table: torch.Tensor,
                        params: TFHEParams) -> torch.Tensor:
    """``cmux_step`` on the Karatsuba product: ``table`` the step's leaf
    table int8 (2, 9, 4, 2L, N/2) (a row of ``leaf_table``).  Four
    launches: the leaf panels, the tree digits, the nine leaf products and
    their combine with the add (``leaf_combine``); on the card ``rotate`` of
    this one step, ``acc`` not written."""
    B = acc.shape[0]
    N = params.N
    check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    check_tensor("table", table, torch.int8, karatsuba.table_shape(params), acc.device)
    _check_karatsuba(params)
    if not dispatch(acc.device):
        return cmux_step_karatsuba_plain(acc, a_tilde, table, params)
    return rotate(acc, a_tilde[None], table[None], params, "karatsuba")


cmux_step_karatsuba.launches = 0


# --------------------------------------------------------------------- #
# K1 rotations: one C entry per product
# --------------------------------------------------------------------- #
# Each product's rotation entry in csrc/cmux_k.cu.
ROTATIONS = {"schoolbook": "rustfhe_cmux_rotate_k", "karatsuba": "rustfhe_cmux_rotate_karatsuba"}


def step_buffers(product: str, B: int, params: TFHEParams, device: torch.device,
                 stream: int) -> tuple[torch.Tensor, ...]:
    """The calling thread's scratch buffers of K1's steps on ``product`` for
    B rows on ``stream`` (``launch.step_buffer``), holding the last such
    step's: the digits int8 (B, 2L, npad) and panels ``panel_shape`` for
    the schoolbook product; the tree digits int8 (B, 9, 2L, npad), the leaf
    panels int8 (9, 2L, 2, LIMBS, rows, SLICE), npad and rows those of ns =
    N/4, and the leaves int32 (B, 9, 2, ns) for the Karatsuba one."""
    two_l = 2 * params.l
    if product == "schoolbook":
        return (launch.step_buffer("digits", (B, two_l, geometry(params.N)[0]), device, stream),
                launch.step_buffer("panel", panel_shape(params), device, stream))
    ns = params.N // karatsuba.R
    npad, _, rows = geometry(ns)
    return (launch.step_buffer("leaf_digits", (B, karatsuba.T, two_l, npad), device, stream),
            launch.step_buffer("leaf_panel", (karatsuba.T, two_l, 2, LIMBS, rows, SLICE), device,
                               stream),
            launch.step_buffer("leaves", (B, karatsuba.T, 2, ns), device, stream, torch.int32))


def rotate(acc: torch.Tensor, a_steps: torch.Tensor, key: torch.Tensor, params: TFHEParams,
           product: str) -> torch.Tensor:
    """The n = ``a_steps.shape[0]`` steps of a K1 rotation on ``product``
    (a key of ``ROTATIONS``): ``acc`` int32 (B, 2, N), ``a_steps`` int32 (n,
    B), ``key`` the steps' doubled tables int32 (n, 2L, 2, 2N) for the
    schoolbook product, their leaf tables int8 (n, 2, 9, 4, 2L, N/2)
    (``leaf_table``) for the Karatsuba one.  On the card one call of the
    product's rotation entry, which runs the steps' launches in a C loop
    on the current stream, alternating between ``acc`` and one new
    accumulator: step 0 reads ``acc``, and from n = 2 on ``acc`` is
    overwritten; the result is whichever of the two the last step wrote.
    Adds n to ``cmux_step.launches``, and on the Karatsuba product to
    ``cmux_step_karatsuba.launches``.  On the CPU: the loop of ``cmux_step``
    or ``cmux_step_karatsuba`` (their plain versions), ``acc`` left as it
    was."""
    B, n = acc.shape[0], a_steps.shape[0]
    N, two_l = params.N, 2 * params.l
    if product not in ROTATIONS:
        raise ValueError(f"unknown product {product!r}; K1 has {', '.join(ROTATIONS)}")
    if product == "karatsuba":
        _check_karatsuba(params)
        key_dtype, key_shape, step = torch.int8, karatsuba.table_shape(params), cmux_step_karatsuba
    else:
        key_dtype, key_shape, step = torch.int32, (two_l, 2, 2 * N), cmux_step
    check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    check_tensor("a_steps", a_steps, torch.int32, (n, B), acc.device)
    check_tensor("key", key, key_dtype, (n,) + tuple(key_shape), acc.device)
    if not dispatch(acc.device):
        for i in range(n):  # the plain step through the step's own dispatch
            acc = step(acc, a_steps[i], key[i], params)
        return acc
    if product == "schoolbook":  # the Karatsuba step's shapes: _check_karatsuba
        check_shape(N, two_l)
    stream = launch.current_stream(acc.device)
    scratch = step_buffers(product, B, params, acc.device, stream)
    other = torch.empty_like(acc)
    failed, result = ctypes.c_int(-1), ctypes.c_int(0)
    lib = load_library()
    with torch.cuda.device(acc.device):
        err = getattr(lib, ROTATIONS[product])(
            acc.data_ptr(), a_steps.data_ptr(), key.data_ptr(), other.data_ptr(),
            *[t.data_ptr() for t in scratch], n, B, N, params.l, params.bgbit,
            params.decomp_mask, ctypes.byref(failed), ctypes.byref(result), stream)
    launch.check(lib, err, f"{ROTATIONS[product]} (step {failed.value} of {n})")
    cmux_step.launches += n
    if product == "karatsuba":
        cmux_step_karatsuba.launches += n
    return other if result.value else acc


def cmux_rotate(acc: torch.Tensor, a_steps: torch.Tensor, key: torch.Tensor,
                params: TFHEParams, span=trace.OFF) -> torch.Tensor:
    """A blind rotation's n = ``params.n`` steps, ``cmux_step`` on
    ``a_steps[i]`` and ``key[i]`` for i < n, from one host call: ``acc``
    int32 (B, 2, N), ``a_steps`` int32 (n, B) (``bootstrap.rotation_start``),
    ``key`` the prepared key int32 (n, 2L, 2, 2N).  ``rotate`` on the
    product ``product_for`` picks for B rows: the schoolbook steps on
    ``key``, or from ``KARATSUBA_MIN_ROWS`` rows on the Karatsuba steps on
    the key's ``leaf_table``; every output word is the same.  On the card
    ``acc`` is overwritten, and 1 is added to ``cmux_rotate.launches``.
    ``span`` (the caller's open ``trace.span``) gets the product taken as
    its ``product`` attribute."""
    B, n = acc.shape[0], params.n
    N, two_l = params.N, 2 * params.l
    check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    check_tensor("a_steps", a_steps, torch.int32, (n, B), acc.device)
    check_tensor("key", key, torch.int32, (n, two_l, 2, 2 * N), acc.device)
    product = product_for(params, B)
    span.set(product=product)
    if product == "karatsuba":
        key = leaf_table(key, params)
    out = rotate(acc, a_steps, key, params, product)
    if dispatch(acc.device):
        cmux_rotate.launches += 1
    return out


cmux_rotate.launches = 0


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
    check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    check_tensor("panel", panel, torch.int8, panel_shape(params), acc.device)
    if not dispatch(acc.device):
        return cmux_step_panel_plain(acc, a_tilde, panel, params)
    check_shape(N, two_l)
    stream = launch.current_stream(acc.device)
    digits = launch.step_buffer("digits", (B, two_l, geometry(N)[0]), acc.device, stream)
    out = torch.empty_like(acc)
    launch.call(load_library(), "rustfhe_cmux_step_panel", acc, a_tilde, panel, out, digits, B, N,
                params.l, params.bgbit, params.decomp_mask, stream=stream)
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
    check_tensor("digits", digits, torch.int8, (B, two_l, N), digits.device)
    check_tensor("key", key, torch.int32, (two_l, 2, 2 * N), digits.device)
    if not dispatch(digits.device):
        return external_product_plain(digits, key)
    check_shape(N, two_l)
    npad = geometry(N)[0]
    if npad != N:  # the product reads whole 128-byte slices: zeros past N
        digits = F.pad(digits, (0, npad - N))
    elif digits.data_ptr() % 16:  # TMA reads from a 16-byte boundary
        digits = digits.clone()
    panel = torch.empty(panel_shape(params), dtype=torch.int8, device=digits.device)
    out = torch.empty((B, 2, N), dtype=torch.int32, device=digits.device)
    launch.call(load_library(), "rustfhe_external_product_k", digits, key, out, panel, B, N,
                two_l)
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
    check_tensor("key", key, torch.int32, (two_l, 2, 2 * N), key.device)
    if out is not None:
        check_tensor("out", out, torch.int8, panel_shape(params), key.device)
    if not dispatch(key.device):
        panel = key_panel_plain(key, params)
        return panel if out is None else out.copy_(panel)
    check_shape(N, two_l)
    panel = torch.empty(panel_shape(params), dtype=torch.int8,
                        device=key.device) if out is None else out
    launch.call(load_library(), "rustfhe_key_panel", key, panel, N, two_l)
    key_panel.launches += 1
    return panel


key_panel.launches = 0


def step_digits_plain(acc: torch.Tensor, a_tilde: torch.Tensor,
                      params: TFHEParams) -> torch.Tensor:
    """The digits of X^{a~} * acc - acc (``plain.step_digits``) as int8 (B,
    2L, npad), zeros past N."""
    digits = plain.step_digits(acc, a_tilde, params).to(torch.int8)
    return F.pad(digits, (0, geometry(params.N)[0] - params.N)).contiguous()


def step_digits(acc: torch.Tensor, a_tilde: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """``step_digits_plain``'s function on the device of ``acc``."""
    B = acc.shape[0]
    N, two_l = params.N, 2 * params.l
    check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    check_tensor("a_tilde", a_tilde, torch.int32, (B,), acc.device)
    if not dispatch(acc.device):
        return step_digits_plain(acc, a_tilde, params)
    check_shape(N, two_l)
    digits = torch.empty((B, two_l, geometry(N)[0]), dtype=torch.int8, device=acc.device)
    launch.call(load_library(), "rustfhe_step_digits", acc, a_tilde, digits, B, N, params.l,
                params.bgbit, params.decomp_mask)
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
    check_tensor("digits", digits, torch.int8, (B, two_l, geometry(N)[0]), digits.device)
    check_tensor("panel", panel, torch.int8, panel_shape(params), digits.device)
    check_tensor("acc", acc, torch.int32, (B, 2, N), digits.device)
    if not dispatch(digits.device):
        return panel_product_plain(digits, panel, acc, params)
    check_shape(N, two_l)
    out = torch.empty_like(acc)
    launch.call(load_library(), "rustfhe_panel_product", digits, panel, acc, out, B, N, two_l)
    return out


# The Karatsuba step's combine's plain version: the tree combine in the standard layout.
leaf_combine_plain = karatsuba.combine_leaves


def leaf_combine(acc: torch.Tensor, leaves: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """The Karatsuba step's last launch, ``leaf_combine_plain``'s function
    on the device of ``acc``: ``acc`` int32 (B, 2, N) plus the tree combine
    of ``leaves`` int32 (B, 9, 2, N/4), the step's leaf products."""
    B, N = acc.shape[0], params.N
    check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    check_tensor("leaves", leaves, torch.int32, (B, karatsuba.T, 2, N // karatsuba.R), acc.device)
    _check_karatsuba(params)
    if not dispatch(acc.device):
        return leaf_combine_plain(acc, leaves)
    out = torch.empty_like(acc)
    launch.call(load_library(), "rustfhe_leaf_combine", acc, leaves, out, B, N, params.l,
                params.bgbit)
    return out


def reset_counters() -> None:
    for fn in (cmux_step, cmux_rotate, cmux_step_karatsuba, cmux_step_panel, external_product,
               key_panel):
        fn.launches = 0
