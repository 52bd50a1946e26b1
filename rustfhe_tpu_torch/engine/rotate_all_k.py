"""The whole blind rotation in one launch (K3), the latency path's kernel.

Counterpart of ``rustfhe_tpu/engine/pallas_k.py``: K3 replaces
``fused_rotate_all_k`` (pallas_k.py:432) and the engine method that calls
it, ``rotate_all_steps`` (pallas_k.py:670).  The kernel is CUDA C++ for
sm_90a in ``csrc/rotate_all_k.cu`` (with ``csrc/cmux_common.cuh``, shared
with K1), built with nvcc on first use (``build``) and called through
ctypes.  It reads the standard prepared key that K1 reads; the JAX
kernel's panel tables are not needed.

``rotate_all`` dispatches on the device of its tensors: a CPU tensor takes
the plain version (the loop of ``cmux_k.cmux_step_plain`` over the n
steps), a CUDA tensor launches the kernel or raises.
``rotate_all.launches`` counts the kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..params import TFHEParams
from . import build, cmux_k

# ``bootstrap.blind_rotate`` takes K3 for a latency key when the flattened
# batch is at most this, and the K1 loop above it (with one warning).  The
# crossover measured on an NVIDIA H100 80GB HBM3 at 700 W, DEFAULT_PARAMS:
# K3 282 ms against the K1 loop's 351 ms per rotation at B=256, 545 against
# 352 at B=512 (PERF.md, latency section).
MAX_BATCH = 256


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the library of ``csrc/rotate_all_k.cu``.
    Raises RuntimeError when no CUDA device is available."""
    lib = build.load("rotate_all_k")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rustfhe_rotate_all_k.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ctypes.c_uint,
                                         vp]
    lib.rustfhe_rotate_all_k.restype = ci
    lib.rustfhe_rotate_all_clusters.argtypes = [ci, ci, ctypes.POINTER(ci)]
    lib.rustfhe_rotate_all_clusters.restype = ci
    return lib


def _check(err: int, what: str) -> None:
    cmux_k._check(cmux_k.load_library(), err, what)


def max_clusters(params: TFHEParams) -> int:
    """Clusters (one sample each) that the current CUDA device holds at
    once.  Raises when it holds none, or the shape is not supported."""
    lib = load_library()
    num = ctypes.c_int(0)
    _check(lib.rustfhe_rotate_all_clusters(params.N, params.l, ctypes.byref(num)),
           "rotate_all_k cluster query")
    return num.value


def rotate_all_plain(acc: torch.Tensor, a_steps: torch.Tensor, bk: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """K3's plain version: n steps of ``cmux_k.cmux_step_plain``."""
    for i in range(bk.shape[0]):
        acc = cmux_k.cmux_step_plain(acc, a_steps[i], bk[i], params)
    return acc


def rotate_all(acc: torch.Tensor, a_steps: torch.Tensor, bk: torch.Tensor,
               params: TFHEParams) -> torch.Tensor:
    """The blind rotation of a batch: ``acc`` int32 (B, 2, N) (the first
    accumulator, ``bootstrap.rotation_start``), ``a_steps`` int32 (n, B) in
    [0, 2N), ``bk`` the prepared key int32 (n, 2L, 2, 2N).  Returns the
    rotated accumulator int32 (B, 2, N)."""
    B = acc.shape[0]
    n, N, two_l = params.n, params.N, 2 * params.l
    cmux_k._check_tensor("acc", acc, torch.int32, (B, 2, N), acc.device)
    cmux_k._check_tensor("a_steps", a_steps, torch.int32, (n, B), acc.device)
    cmux_k._check_tensor("bk", bk, torch.int32, (n, two_l, 2, 2 * N), acc.device)
    if not cmux_k._dispatch(acc.device):
        return rotate_all_plain(acc, a_steps, bk, params)
    lib = load_library()
    out = torch.empty_like(acc)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.rustfhe_rotate_all_k(
            acc.data_ptr(), a_steps.data_ptr(), bk.data_ptr(), out.data_ptr(), acc.shape[0],
            params.n, params.N, params.l, params.bgbit, params.decomp_mask, stream)
    _check(err, "rotate_all_k")
    rotate_all.launches += 1
    return out


rotate_all.launches = 0
