"""Lazy builder for the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface (it
may include the shared headers ``csrc/*.cuh``). On
its first use in a process, :func:`load` compiles it with ``nvcc`` into a
shared library under ``tpu_pathtracer_torch/_build/`` and loads it with
``ctypes``. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Importing this module builds nothing, so the package imports on a
machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false and no --use_fast_math: the kernels round as the plain
# PyTorch versions do (IEEE sqrtf, no contraction into FMA).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LOADED: dict = {}  # name -> ctypes.CDLL, loaded once per process


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME``, else the
    toolkit's default install prefix. Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME): the CUDA "
                       "kernels need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` goes. The hash
    covers the shared headers ``csrc/*.cuh`` too."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is current; returns
    the library's path. The compiler's output (ptxas register and
    shared-memory lines) is kept beside it as ``.log``. Raises with the
    compiler's output if the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
