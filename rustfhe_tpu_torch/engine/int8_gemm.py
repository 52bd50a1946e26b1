"""The blocked int8 GEMM on the tensor cores (P7, P9).

Counterpart of two Pallas probe kernels of the JAX package that time the
TPU's matrix unit on int8 operands: P7 ``make_dot``
(``benches/step_breakdown_probe.py:175``, a bare dot tile at the CMux
step's contraction depth, (B, 6144) @ (6144, 1024)) and P9
``make_pallas`` (``benches/pallas_matmul_probe.py:56``, the blocked GEMM
at the external product's shape, (B, 6144) @ (6144, 8192)).  Both compute
``d @ w`` on int8 operands with int32 sums.  It is also the product of
every blind-rotate step of the ``"matmul"`` engine (``engine/matmul.py``).

What bounds it is int8 tensor-core issue (1,979 dense TOP/s published for
the H100 SXM), then the stores of the int32 output.  One CUDA C++ template
for sm_90a in ``csrc/int8_gemm.cu`` serves both probes, instantiated at the
tiles of ``TILES``: a producer warpgroup whose one thread keeps a ring of
``STAGES`` shared-memory stages full with TMA copies of ``DEPTH`` bytes of
K (128-byte swizzle, a full and an empty mbarrier per stage), and one or
two consumer warpgroups that run ``wgmma`` (m64nBNk32, s8 x s8 -> s32) on
the stages through shared-memory descriptors, one stage's products
overlapping the next one's copies.  Those building blocks live in
``csrc/hopper_common.cuh``, shared with the CMux step's product (K1, K2 in
``csrc/cmux_k.cu``).  It is built with nvcc into a library with a plain C
interface on first use and called through ctypes (``launch``).

The wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises.  ``int8_matmul.launches`` counts the kernel launches, and nothing
else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import launch, limb_step
from .launch import INT, VP, check_tensor, dispatch

# Block tiles (rows of d, columns of w) of the kernel's instantiations, by
# the index the C entry takes: 64x64 runs one consumer warpgroup (m64n64),
# 128x128 and 128x256 two (m64n128, m64n256).  The depth is cut in slices
# of DEPTH bytes (one row of the 128-byte swizzle), STAGES of them in flight.
TILES = {"64x64": 0, "128x128": 1, "128x256": 2}
TILE = "128x256"  # the fastest at P7's, P9's and the "matmul" step's shapes (PERF.md)
DEPTH = 128
STAGES = 4
ALIGN = 1024  # slack to put the ring on a 128-byte swizzle atom


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the library of ``csrc/int8_gemm.cu``.
    Raises RuntimeError when no CUDA device is available."""
    return launch.bind("int8_gemm", {"rustfhe_int8_gemm": [VP, VP, VP, INT, INT, INT, INT, VP]})


def tile_shape(tile: str) -> tuple[int, int]:
    if tile not in TILES:
        raise ValueError(f"unknown tile {tile!r}; the kernel has {', '.join(TILES)}")
    bm, bn = tile.split("x")
    return int(bm), int(bn)


def smem_bytes(tile: str) -> int:
    """Shared memory of one block at ``tile``, as ``csrc/int8_gemm.cu``
    asks for it: the alignment slack, STAGES stages of the A and Bt tiles
    (DEPTH bytes of each row), and a full and an empty 8-byte mbarrier per
    stage."""
    bm, bn = tile_shape(tile)
    return ALIGN + STAGES * (bm + bn) * DEPTH + 2 * STAGES * 8


def check_bound(K: int) -> None:
    """Raise unless every int32 sum, K * 128 * 128 at most in magnitude
    (int8 operands), stays below 2^31."""
    bound = K * 128 * 128
    if bound >= 1 << 31:
        raise ValueError(f"int8 sums reach K*128*128 = {bound} >= 2^31 at K={K}: outside "
                         "the exact int32 range")


def prepare_rhs(w: torch.Tensor) -> torch.Tensor:
    """w int8 (K, N) -> (N, K) row-major, the layout the kernel reads.

    ``wgmma`` reads both 8-bit operands K-major (no transpose for 8-bit
    types), so the weights are transposed once, outside any timed loop: the
    counterpart of the TPU probes' panel build."""
    if w.dtype != torch.int8 or w.dim() != 2:
        raise TypeError(f"w must be a 2-D int8 tensor, got {w.dtype} with shape {tuple(w.shape)}")
    return w.t().contiguous()


def int8_matmul_plain(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: d (M, K) int8 @ w (K, N) int8 as a float64
    product cast to int32.  Exact: every partial sum is an integer of
    magnitude at most K * 2^14, far below 2^53 (and below 2^31 under
    ``check_bound``)."""
    if d.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"operands must be int8, got {d.dtype} and {w.dtype}")
    check_bound(d.shape[-1])
    return (d.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def int8_matmul(d: torch.Tensor, wt: torch.Tensor, tile: str = TILE) -> torch.Tensor:
    """d (M, K) int8 @ w (K, N) int8 -> int32 (M, N), with the weights given
    as ``wt = prepare_rhs(w)``, (N, K), at block tile ``tile`` (a key of
    ``TILES``).  M must be a multiple of the tile's rows, N of its columns
    and K of DEPTH, or it raises ValueError, on either device: the kernel
    has no ragged edge, and the plain version keeps its contract."""
    bm, bn = tile_shape(tile)
    if d.dim() != 2 or wt.dim() != 2:
        raise ValueError(f"d and wt must be 2-D, got {tuple(d.shape)} and {tuple(wt.shape)}")
    M, K = d.shape
    N = wt.shape[0]
    check_tensor("d", d, torch.int8, (M, K), d.device)
    check_tensor("wt", wt, torch.int8, (N, K), d.device)
    check_bound(K)
    if M % bm or N % bn or K % DEPTH or min(M, N, K) < 1:
        raise ValueError(f"shape (M, K, N) = ({M}, {K}, {N}) does not divide tile {tile}: M "
                         f"must be a multiple of {bm}, N of {bn} and K of {DEPTH}")
    if not dispatch(d.device):
        return int8_matmul_plain(d, wt.t())
    if d.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("d and wt must start on a 16-byte boundary")
    device = d.device.index if d.device.index is not None else torch.cuda.current_device()
    need, limit = smem_bytes(tile), limb_step.smem_optin(device)
    if need > limit:
        raise ValueError(f"tile {tile} needs {need} bytes of shared memory per block, over the "
                         f"card's opt-in limit of {limit} bytes")
    out = torch.empty((M, N), dtype=torch.int32, device=d.device)
    launch.call(load_library(), "rustfhe_int8_gemm", d, wt, out, M, N, K, TILES[tile])
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def reset_counters() -> None:
    int8_matmul.launches = 0
