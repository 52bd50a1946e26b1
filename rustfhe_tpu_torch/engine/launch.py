"""How the engine's wrappers call their CUDA libraries.

Every ``csrc/*.cu`` is one shared library with a plain C interface, which
``build`` compiles with nvcc at first use; ``bind`` loads it and gives its
entries their ctypes signatures.  Every entry returns the ``cudaError_t``
of its launches, and every library exports ``rustfhe_cuda_error_string``
(``csrc/error_string.cuh``), so ``check`` decodes a library's errors with
the library itself.  A wrapper checks its tensors (``check_tensor``), picks
the kernel or its plain version by their device (``dispatch``), and issues
an entry with ``call``: that device current, tensors passed by address, on
the device's current stream (``current_stream``) unless it names one.
Steps that run back to back keep their scratch in ``step_buffer``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build

# The C types of the entries' arguments: pointers, int, unsigned int, int*.
VP, INT, UINT = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
INT_P = ctypes.POINTER(ctypes.c_int)


def bind(name: str, entries: dict[str, list]) -> ctypes.CDLL:
    """Build (first use) and load the library of ``csrc/<name>.cu`` and give
    each of ``entries`` ({C name: argument types}) its argument types and
    an int result, and the library's error string its signature.  Raises
    RuntimeError when no CUDA device is available."""
    lib = build.load(name)
    for entry, args in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.rustfhe_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rustfhe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, err: int, what: str) -> None:
    """Raise RuntimeError naming ``what`` unless ``err``, a ``cudaError_t``
    that an entry of ``lib`` returned, is 0."""
    if err != 0:
        msg = lib.rustfhe_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` has ``dtype`` (TypeError), ``shape``, ``device``
    and a contiguous layout (ValueError): what an entry reads by address."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dispatch(device: torch.device) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def current_stream(device: torch.device) -> int:
    """The address of ``device``'s current CUDA stream."""
    return torch.cuda.current_stream(device).cuda_stream


def call(lib, entry: str, *args, stream: int | None = None) -> None:
    """``lib.<entry>(*args, stream)`` with the first tensor's device current,
    tensors passed by address, on ``stream`` or that device's current
    stream; raises (``check``) naming the entry."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                                    for a in args],
                                  current_stream(device) if stream is None else stream)
    check(lib, err, entry)


_scratch = threading.local()  # each thread's step buffers, {(device, stream, role): tensor}


def step_buffer(role: str, shape: tuple[int, ...], device: torch.device, stream: int,
                dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """The calling thread's ``role`` buffer (the digits, the panels or the
    leaves of a step; one dtype a role) for steps on ``stream``, kept while
    its shape holds.  Steps on one stream run in order, so a step never
    overwrites a buffer that an earlier step still reads, and no other
    thread's step writes it.  Two allocations per step made the host-bound
    K1 loop at B <= 32 8-25 % slower (PERF.md §6)."""
    bufs = _scratch.__dict__.setdefault("bufs", {})
    buf = bufs.get((device, stream, role))
    if buf is None or tuple(buf.shape) != shape:
        buf = bufs[device, stream, role] = torch.empty(shape, dtype=dtype, device=device)
    return buf
