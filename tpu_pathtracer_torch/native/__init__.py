"""Native (C++) host-side BVH builders (counterpart of
``tpu_pathtracer/native``): the heap's SAH build order and the binary
SAH tree that the BVH4 tables collapse.

``bvh_builder.cpp`` is a copy of the JAX package's source: the port
cannot import ``tpu_pathtracer.native``, because importing any module of
that package imports jax. On first use in a process,
:func:`native_build_order` or :func:`native_bvh4_binary` compiles it
with ``g++`` (the JAX package's flags) into a shared library under
``tpu_pathtracer_torch/_build/`` and loads it with ``ctypes``. The
library's file name carries a hash of the source and the flags. Any
failure to build or load leaves the library unavailable, and callers fall
back to the NumPy builders. Importing this module builds nothing.
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
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_longlong)
        lib.bvh4_build_binary.restype = ctypes.c_int
        lib.bvh4_build_binary.argtypes = [
            f32p, f32p, f32p,                # v0/v1/v2 [T*3]
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # T, width, n_bins
            ctypes.c_float, ctypes.c_float,  # ci, ct
            f32p, f32p,                      # bmin/bmax [cap*3]
            i64p, i64p,                      # c0/c1 [cap]
            i64p,                            # order [T]
            i64p, i64p,                      # leaf_first/leaf_count [cap]
            i64p,                            # meta [2]: n_nodes, depth
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


def native_bvh4_binary(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                       width: int, n_bins: int, ci: float, ct: float):
    """Binned-SAH binary tree under the per-visit cost model from the C++
    builder (the contract of ``ops.bvh4._build_sah_binary``), or None if
    the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    a0 = np.ascontiguousarray(v0, np.float32)
    a1 = np.ascontiguousarray(v1, np.float32)
    a2 = np.ascontiguousarray(v2, np.float32)
    T = a0.shape[0]
    cap = 2 * T  # every interior node has two children, every leaf >= 1
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    c0 = np.empty(cap, np.int64)
    c1 = np.empty(cap, np.int64)
    order = np.empty(T, np.int64)
    lf = np.zeros(cap, np.int64)
    lc = np.zeros(cap, np.int64)
    meta = np.zeros(2, np.int64)
    rc = lib.bvh4_build_binary(
        a0.ctypes.data_as(f32p), a1.ctypes.data_as(f32p),
        a2.ctypes.data_as(f32p), T, int(width), int(n_bins),
        float(ci), float(ct),
        bmin.ctypes.data_as(f32p), bmax.ctypes.data_as(f32p),
        c0.ctypes.data_as(i64p), c1.ctypes.data_as(i64p),
        order.ctypes.data_as(i64p),
        lf.ctypes.data_as(i64p), lc.ctypes.data_as(i64p),
        meta.ctypes.data_as(i64p))
    if rc != 0:
        return None
    n = int(meta[0])
    return (bmin[:n], bmax[:n], c0[:n], c1[:n], order,
            lf[:n], lc[:n], int(meta[1]))
