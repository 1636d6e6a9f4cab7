"""Native (C++) host-side BVH build order (counterpart of
``tpu_pathtracer/native``).

``bvh_builder.cpp`` is a copy of the JAX package's source: the port
cannot import ``tpu_pathtracer.native``, because importing any module of
that package imports jax. On first use in a process, :func:`native_build_order`
compiles it with ``g++`` (the JAX package's flags) into a shared library
under ``tpu_pathtracer_torch/_build/`` and loads it with ``ctypes``. The
library's file name carries a hash of the source and the flags. Any
failure to build or load leaves the library unavailable, and callers fall
back to the NumPy median builder (``builder="auto"``). Importing this
module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_LIB = None
_TRIED = False


def library_path() -> Path:
    """Where the library built from ``bvh_builder.cpp`` goes."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libbvh_builder-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """Compile the builder (~2 s); False on any failure."""
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return False
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(_SRC)],
                           capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, path)  # atomic: concurrent builders agree
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The loaded builder library, or None if it cannot be built."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.bvh_build_order.restype = ctypes.c_int
        lib.bvh_build_order.argtypes = [
            ctypes.POINTER(ctypes.c_float),     # tri mins [T*3]
            ctypes.POINTER(ctypes.c_float),     # tri maxs [T*3]
            ctypes.c_int,                       # T
            ctypes.c_int,                       # num_leaves
            ctypes.c_int,                       # prims_per_leaf
            ctypes.POINTER(ctypes.c_longlong),  # out slots [num_leaves*P]
        ]
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


def native_build_order(tri_min: np.ndarray, tri_max: np.ndarray,
                       num_leaves: int, prims_per_leaf: int):
    """SAH-binned partition order from the C++ builder (original triangle
    index per padded slot, -1 for padding), or None if the library is
    unavailable."""
    lib = load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(tri_min, np.float32)
    hi = np.ascontiguousarray(tri_max, np.float32)
    out = np.full(num_leaves * prims_per_leaf, -1, np.int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.bvh_build_order(
        lo.ctypes.data_as(f32p), hi.ctypes.data_as(f32p), lo.shape[0],
        num_leaves, prims_per_leaf,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    if rc != 0:
        return None
    return out
