"""Build and load the CUDA kernel libraries of ``csrc/``.

Every ``csrc/*.cu`` is one shared library with a plain C interface, built
with nvcc for sm_90a into the git-ignored ``build/`` at first use and bound
through ctypes by the module that wraps its kernels.  One hash over every
source in ``csrc/`` (``.cu`` and ``.cuh``) and the flags names all the
libraries of one tree, so a change to a shared header rebuilds them all.
The nvcc processes of a build run side by side.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..utils import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(f"nvcc not found: the CUDA kernels are built from {CSRC} "
                       "with the CUDA toolkit's nvcc")


def sources() -> list[Path]:
    """The kernel sources, one library each."""
    return sorted(CSRC.glob("*.cu"))


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_tag()}.so"


def build() -> dict[str, tuple[Path, str]]:
    """Compile every source whose library of this tree is missing, all
    nvcc processes at once.  Returns {name: (library path, nvcc's output:
    the ptxas register and spill report, empty when it was cached)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, tuple[Path, str]] = {}
    running = []
    try:
        for src in sources():
            lib = library_path(src.stem)
            if lib.exists():
                out[src.stem] = (lib, "")
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((src, lib, tmp, proc))
        failed = []
        for src, lib, tmp, proc in running:
            report, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}: nvcc failed ({proc.returncode}):\n{report}")
                continue
            os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
            out[src.stem] = (lib, report)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (first use) and load the library of ``csrc/<name>.cu``.
    Raises RuntimeError when no CUDA device is available: the kernels never
    run elsewhere."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device, and "
                           "torch.cuda.is_available() is False")
    with trace.span("setup.kernels", library=name) as span:
        path = library_path(name)
        built = not path.exists()
        span.set(built=built)
        if built:
            path = build()[name][0]
        return ctypes.CDLL(str(path))
