"""The whole blind rotation in one launch (K3), the latency path's kernel.

Counterpart of ``rustfhe_tpu/engine/pallas_k.py``: K3 replaces
``fused_rotate_all_k`` (pallas_k.py:432) and the engine method that calls
it, ``rotate_all_steps`` (pallas_k.py:670).  The kernel is CUDA C++ for
sm_90a in ``csrc/rotate_all_k.cu`` (with ``csrc/cmux_common.cuh``, shared
with K1), built with nvcc on first use (``build``) and called through
ctypes (``launch``).  It reads the standard prepared key that K1 reads;
the JAX kernel's panel tables are not needed.

One sample runs on one thread-block cluster of at most N/64 blocks: 16
while the card holds the whole batch at that size at once, else 8
(``cluster_for``).  Each step is an int8 tensor-core product
(``mma.sync``) in the orientation that wastes nothing at B=1: the output
coefficients in M, the 8 columns (half, limb) in N, (plane, index) in K,
A the negacyclic circulant of the sample's own digits held as the doubled
reversed array [-d, d], B the balanced int8 limbs of the key's q half
(``circulant_step_plain`` computes a step that way).  It takes N a power
of two in [64, 2048] and Bg <= 2^7 with exact int32 sums
(``check_shape``); its shared-memory layout lives in the CUDA source
alone, whose launch refuses one over the card's opt-in limit.

``rotate_all`` dispatches on the device of its tensors: a CPU tensor takes
the plain version (the loop of ``cmux_k.cmux_step_plain`` over the n
steps), a CUDA tensor launches the kernel or raises.
``rotate_all.launches`` counts the kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import poly
from .._u32 import wrap
from ..params import TFHEParams
from . import cmux_k, launch
from .launch import INT, UINT, VP

# ``bootstrap.blind_rotate`` takes K3 for a latency key when the flattened
# batch is at most this, and the K1 loop above it: the crossover measured
# by chip_smoke.py phase 7 on an NVIDIA H100 80GB HBM3 at 700 W (medians of
# 7 rounds, PERF.md): K3 24.2-24.3 ms against the K1 loop's 29.1-32.0 per
# rotation at B=64, 43.8 against 31.8-37.1 at B=128.
MAX_BATCH = 64
# Blocks of one sample's cluster (at most N / 64): 8 (portable) or 16.
CLUSTERS = (8, 16)
MIN_N, MAX_N = 64, 2048


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the library of ``csrc/rotate_all_k.cu``.
    Raises RuntimeError when no CUDA device is available."""
    return launch.bind("rotate_all_k", {
        "rustfhe_rotate_all_k": [VP, VP, VP, VP, INT, INT, INT, INT, INT, UINT, INT, VP],
        "rustfhe_rotate_all_clusters": [INT, INT, INT, ctypes.POINTER(INT)],
        "rustfhe_rotate_all_barrier_floor": [INT, INT, INT, INT, VP]})


@functools.lru_cache(maxsize=None)
def _held(device_index: int, N: int, l: int, cluster: int) -> int:
    with torch.cuda.device(device_index):
        return max_clusters(TFHEParams(N=N, l=l), cluster)


def cluster_for(B: int, params: TFHEParams, device: torch.device) -> int:
    """The cluster for a batch of B: 16 blocks while the card holds all B
    such clusters at once, else 8, whose clusters it holds twice as many
    of.  At DEFAULT_PARAMS on an H100 (PERF.md) 16 blocks were ~15 %
    faster at B=1 and 8 ~20 % faster at B=16 (the card holds 7 clusters of
    16 there, 15 of 8)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return 16 if B <= _held(index, params.N, params.l, 16) else 8


def check_shape(params: TFHEParams) -> None:
    """Raise ValueError unless the kernel takes the shape: N a power of two
    in [MIN_N, MAX_N], Bg <= 2^7 (the digits' negation fits int8), and every
    int32 sum of the product, half_bg * 128 * 2L * N at most, below 2^31."""
    N = params.N
    if not MIN_N <= N <= MAX_N or N & (N - 1):
        raise ValueError(f"K3 takes N a power of two in [{MIN_N}, {MAX_N}], got {N}")
    if params.bgbit > 7:
        raise ValueError(f"K3 takes Bg <= 2^7 (the sign goes on int8 digits), got "
                         f"Bg = 2^{params.bgbit}")
    bound = params.half_bg * 128 * 2 * params.l * N
    if bound >= 1 << 31:
        raise ValueError(f"int8 sums reach half_bg*128*2L*N = {bound} >= 2^31: outside the "
                         "exact int32 range")


def takes(params: TFHEParams) -> bool:
    """Whether K3 takes the shape (``check_shape``): ``bootstrap.blind_rotate``
    runs the K1 loop for a latency key whose shape it does not take."""
    try:
        check_shape(params)
    except ValueError:
        return False
    return True


def max_clusters(params: TFHEParams, cluster: int) -> int:
    """Clusters (one sample each) that the current CUDA device holds at
    once.  Raises when it holds none, or the shape is not supported."""
    lib = load_library()
    num = ctypes.c_int(0)
    launch.check(lib, lib.rustfhe_rotate_all_clusters(params.N, params.l, cluster,
                                                      ctypes.byref(num)),
                 "rotate_all_k cluster query")
    return num.value


def barrier_floor(B: int, params: TFHEParams, device, cluster: int) -> None:
    """Launch B clusters of K3's shape that pass params.n cluster barriers
    and do nothing else: the latency floor under a rotation's n dependent
    steps, for timing (not on any path, not counted)."""
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.rustfhe_rotate_all_barrier_floor(B, params.n, params.N, cluster,
                                                   launch.current_stream(device))
    launch.check(lib, err, "rotate_all_k barrier floor")


def rotate_all_plain(acc: torch.Tensor, a_steps: torch.Tensor, bk: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """K3's plain version: n steps of ``cmux_k.cmux_step_plain``."""
    for i in range(bk.shape[0]):
        acc = cmux_k.cmux_step_plain(acc, a_steps[i], bk[i], params)
    return acc


def circulant_step_plain(acc: torch.Tensor, a_tilde: torch.Tensor, key: torch.Tensor,
                         params: TFHEParams) -> torch.Tensor:
    """One CMux step as K3's product computes it, exact in int64: per
    sample and plane j, A[k, m] = R_j[N - 1 - k + m] with R_j the reversed
    doubled digits [-d_j, d_j], against B[m, (c, t)] = limb_t(q_jc[m]) for
    the key's q half q_jc = key[j, c, N:]; P summed over every plane,
    recombined as sum_t P << 8t mod 2^32 and added to ``acc``.  ``key`` is
    the step's doubled table int32 (2L, 2, 2N)."""
    N = params.N
    digits = cmux_k.step_digits_plain(acc, a_tilde, params)[..., :N].to(torch.int64)
    R = torch.cat([-digits, digits], dim=-1).flip(-1)  # (B, 2L, 2N)
    k = torch.arange(N, device=acc.device)
    idx = N - 1 - k[:, None] + k[None, :]  # (k, m) -> index into R
    limbs = poly.to_signed_limbs(key[..., N:], 8, 4).to(torch.int64)  # (2L, 2, N, 4)
    cols = limbs.permute(0, 2, 1, 3).reshape(key.shape[0], N, 8)  # (2L, m, (c, t))
    P = torch.zeros((acc.shape[0], N, 8), dtype=torch.int64, device=acc.device)
    for j in range(key.shape[0]):
        P += R[:, j][:, idx] @ cols[j]  # (B, k, m) @ (m, (c, t))
    P = P.reshape(acc.shape[0], N, 2, 4)
    out = sum(P[..., t] << (8 * t) for t in range(4))  # (B, k, c)
    return acc + wrap(out.transpose(1, 2))


def _rotate_all(acc: torch.Tensor, a_steps: torch.Tensor, bk: torch.Tensor,
                params: TFHEParams, cluster: int) -> torch.Tensor:
    """K3's launch on the card with clusters of up to ``cluster`` blocks."""
    check_shape(params)
    if cluster not in CLUSTERS:
        raise ValueError(f"K3's cluster takes {' or '.join(map(str, CLUSTERS))} blocks, "
                         f"got {cluster}")
    if bk.data_ptr() % 16:
        raise ValueError("bk must start on a 16-byte boundary (cp.async reads it in 16 bytes)")
    out = torch.empty_like(acc)
    launch.call(load_library(), "rustfhe_rotate_all_k", acc, a_steps, bk, out, acc.shape[0],
                params.n, params.N, params.l, params.bgbit, params.decomp_mask, cluster)
    return out


def rotate_all(acc: torch.Tensor, a_steps: torch.Tensor, bk: torch.Tensor,
               params: TFHEParams) -> torch.Tensor:
    """The blind rotation of a batch: ``acc`` int32 (B, 2, N) (the first
    accumulator, ``bootstrap.rotation_start``), ``a_steps`` int32 (n, B) in
    [0, 2N), ``bk`` the prepared key int32 (n, 2L, 2, 2N).  Returns the
    rotated accumulator int32 (B, 2, N)."""
    B = acc.shape[0]
    n, N, two_l = params.n, params.N, 2 * params.l
    launch.check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    launch.check_tensor("a_steps", a_steps, torch.int32, (n, B), acc.device)
    launch.check_tensor("bk", bk, torch.int32, (n, two_l, 2, 2 * N), acc.device)
    if not launch.dispatch(acc.device):
        return rotate_all_plain(acc, a_steps, bk, params)
    check_shape(params)
    out = _rotate_all(acc, a_steps, bk, params, cluster_for(B, params, acc.device))
    rotate_all.launches += 1
    return out


rotate_all.launches = 0
