"""The host library: negacyclic products in C++ and the circuit levelizer.

Counterpart of ``rustfhe_tpu/native.py``.  The JAX package binds its host
library (``native/negacyclic.cpp``) through ctypes; the port carries its
own copy of the products' source, ``csrc/negacyclic_host.cpp``, built at
first use with the host C++ compiler (``g++``, else ``c++``) and the JAX
Makefile's flags into the git-ignored ``build/``, and bound through ctypes
in the same way.  The library is named by a hash over its source, the
flags and the compiler's view of the host (``-march=native`` makes the
code the host's own), so a checkout copied to another machine builds its
own.  It is host code: no device path calls it.

The JAX contract holds: ``available()`` says whether the library built and
loaded, and every product has a numpy fallback (the ``*_numpy``
functions, the JAX module's fallbacks) that runs when it did not.  numpy
in, numpy out.  ``levelize`` stays the port's numpy loop: it gives the JAX
native levelizer's levels and refuses the wire ids it refuses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .poly import negacyclic_mul_i64

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "negacyclic_host.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

_LIB = None
_TRIED = False


def compiler() -> str | None:
    """The host C++ compiler: ``g++``, else ``c++``; None if neither."""
    return shutil.which("g++") or shutil.which("c++")


def library_path(cxx: str) -> Path:
    """The library of this source, these flags and this host's target
    (``cxx -march=native -Q --help=target``: the ISA extensions
    ``-march=native`` turns on)."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"], capture_output=True,
                            check=True, timeout=60).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + target + b"\0")
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnegacyclic_host-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this host's is built; its path.  The
    compiler writes a temporary file that is renamed into place, so a
    concurrent build never loads half a file.  Raises RuntimeError without
    a compiler, ``subprocess.CalledProcessError`` when it fails."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(f"no host C++ compiler (g++ or c++) to build {SOURCE.name}")
    lib = library_path(cxx)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load():
    """The bound library, built at first use; None when it cannot be built
    or loaded (the numpy fallbacks run then, as in the JAX package)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.negacyclic_mul_u32_exact.argtypes = [u32p, i32p, u32p, ctypes.c_int64]
    lib.negacyclic_mul_u32_exact.restype = None
    lib.negacyclic_mul_f64_fft.argtypes = [f64p, f64p, f64p, ctypes.c_int64]
    lib.negacyclic_mul_f64_fft.restype = ctypes.c_int
    lib.negacyclic_mul_torus_fft.argtypes = [u32p, i32p, u32p, ctypes.c_int64]
    lib.negacyclic_mul_torus_fft.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _operands(a, b, a_dtype, b_dtype) -> tuple[np.ndarray, np.ndarray]:
    """Contiguous 1-D operands of one length: the library reads ``n``
    words of each, so anything else is refused before a pointer is passed."""
    a = np.ascontiguousarray(a, a_dtype)
    b = np.ascontiguousarray(b, b_dtype)
    if a.ndim != 1 or a.shape != b.shape:
        raise ValueError(f"the products take two polynomials of one length, got shapes "
                         f"{a.shape} and {b.shape}")
    return a, b


def negacyclic_mul_u32_exact_numpy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The exact product's fallback: the int64 product mod 2^32."""
    a, b = _operands(a, b, np.uint32, np.int32)
    return (negacyclic_mul_i64(a.astype(np.int64), b) % (1 << 32)).astype(np.uint32)


def negacyclic_mul_f64_fft_numpy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The f64 product's fallback: numpy's FFT with the same psi twist."""
    a, b = _operands(a, b, np.float64, np.float64)
    n = a.shape[-1]
    psi = np.exp(1j * np.pi * np.arange(n) / n)
    fa = np.fft.fft(a * psi)
    fb = np.fft.fft(b * psi)
    return np.real(np.fft.ifft(fa * fb) * np.conj(psi))


def negacyclic_mul_torus_fft_numpy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The torus product's fallback: the centred lift through the f64
    fallback, rounded back mod 2^32."""
    a, b = _operands(a, b, np.uint32, np.int32)
    fo = negacyclic_mul_f64_fft_numpy(a.astype(np.int32).astype(np.float64),
                                      b.astype(np.float64))
    return np.round(fo).astype(np.int64).astype(np.uint32)


def negacyclic_mul_u32_exact(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact uint32 negacyclic convolution of torus words ``a`` by small
    integers ``b`` (native, numpy fallback)."""
    a, b = _operands(a, b, np.uint32, np.int32)
    lib = _load()
    if lib is None:
        return negacyclic_mul_u32_exact_numpy(a, b)
    out = np.empty_like(a)
    lib.negacyclic_mul_u32_exact(a, b, out, a.shape[-1])
    return out


def negacyclic_mul_f64_fft(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """psi-twisted FFT negacyclic product of f64 polynomials (native, numpy
    fallback); N a power of two >= 2 on the library."""
    a, b = _operands(a, b, np.float64, np.float64)
    lib = _load()
    if lib is None:
        return negacyclic_mul_f64_fft_numpy(a, b)
    n = a.shape[-1]
    out = np.empty_like(a)
    if lib.negacyclic_mul_f64_fft(a, b, out, n) != 0:
        raise ValueError(f"negacyclic_mul_f64_fft failed (n={n})")
    return out


def negacyclic_mul_torus_fft(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Approximate torus x int product through the f64 FFT (the reference's
    spqlios path; native, numpy fallback)."""
    a, b = _operands(a, b, np.uint32, np.int32)
    lib = _load()
    if lib is None:
        return negacyclic_mul_torus_fft_numpy(a, b)
    out = np.empty_like(a)
    if lib.negacyclic_mul_torus_fft(a, b, out, a.shape[-1]) != 0:
        raise ValueError("negacyclic_mul_torus_fft failed")
    return out


def levelize(n_gates: int, n_wires: int, n_inputs: int,
             inputs3: np.ndarray, outputs: np.ndarray) -> tuple[np.ndarray, int]:
    """Levels of ``n_gates`` gates in topological order: returns (levels
    (n_gates,) int64, 1-based; depth).

    ``inputs3`` (n_gates, 3) holds each gate's input wires, -1 for an
    unused slot; ``outputs`` (n_gates,) its output wire.  A gate's level is
    one more than the highest level of its input wires (primary inputs are
    level 0), counted in gate order.  A wire id outside [0, n_wires)
    raises, as the JAX package's native levelizer refuses it.
    ``n_inputs`` is accepted for the JAX signature and not needed.
    """
    del n_inputs
    ins = np.ascontiguousarray(inputs3, np.int64).reshape(n_gates, 3)
    outs = np.ascontiguousarray(outputs, np.int64).reshape(n_gates)
    if ((ins >= n_wires).any() or (outs < 0).any() or (outs >= n_wires).any()):
        raise ValueError("levelize: wire index out of range")
    wire_level = [0] * n_wires
    levels = []
    for ws, out in zip(ins.tolist(), outs.tolist()):
        lv = 1 + max([wire_level[w] for w in ws if w >= 0], default=0)
        wire_level[out] = lv
        levels.append(lv)
    levels = np.array(levels, np.int64)
    return levels, int(levels.max(initial=0))
