"""Brute-force nearest / any ray–sphere hit: the CUDA kernel
``csrc/spheres.cu`` and its plain PyTorch version (counterpart of
``tpu_pathtracer/ops/pallas_spheres.py``).

The public functions dispatch on the device of their inputs: tensors on
the CPU go to the plain version, tensors on a CUDA device to the kernel
(or the call raises). There is no fallback from one to the other.

Contract of all three modes: the oc-form quadratic with a unit
direction; the near root if it is > t_min, else the far root; a sphere
wins if disc > 0 and t_min < t < t_best, with t_best starting at the
ray's t_max, tested in slot order with a strict <, so the first sphere
wins a tie. A sphere with radius <= 0 carries r² = −r² in the table and
never wins. On a miss t = FLT_MAX, idx = −1 and the features are 0.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

# Kernel launches by the wrappers below, all modes together. Callers
# reset it to 0 and read it back to show that a run went through the
# kernel.
LAUNCHES = 0

_NEAREST, _FEATURES, _ANY_HIT = 0, 1, 2  # csrc/spheres.cu Mode
S_CHUNK = 512  # spheres per pass of the plain version (bounds [N, chunk])


def sphere_table(centers: V3, radii: torch.Tensor) -> torch.Tensor:
    """[S, 4] float32 rows (cx, cy, cz, r²·sign(r)): a slot with radius
    <= 0 gets r² <= 0, so disc < 0 by Cauchy–Schwarz and it never wins."""
    r2 = radii * radii * torch.where(radii > 0, 1.0, -1.0)
    return torch.stack([centers.x, centers.y, centers.z, r2], dim=1)


def _tmax_vector(t_max, n: int, like: torch.Tensor) -> torch.Tensor:
    if isinstance(t_max, torch.Tensor):
        return t_max.to(like.dtype).expand(n).contiguous()
    return torch.full((n,), float(t_max), dtype=like.dtype,
                      device=like.device)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _sphere_ts(origin: V3, direction: V3, tab: torch.Tensor, t_min: float,
               tmax: torch.Tensor) -> torch.Tensor:
    """[N, C] candidate t of each ray against each sphere of the chunk
    ``tab`` [C, 4], FLT_MAX where the sphere cannot win. Each expression
    has the kernel's operation order, so the two round alike."""
    ocx = origin.x[:, None] - tab[:, 0]
    ocy = origin.y[:, None] - tab[:, 1]
    ocz = origin.z[:, None] - tab[:, 2]
    b = ocx * direction.x[:, None] + ocy * direction.y[:, None] \
        + ocz * direction.z[:, None]
    c = ocx * ocx + ocy * ocy + ocz * ocz - tab[:, 3]
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    ts0 = torch.where(t1 > t_min, t1, t2)
    valid = (disc > 0.0) & (ts0 > t_min) & (ts0 < tmax[:, None])
    return torch.where(valid, ts0, FLT_MAX)


def _spheres_hit_ref(origin, direction, centers, radii, t_min, t_max):
    """(t, idx) by chunks over the spheres: the first minimum of each
    chunk, merged by strict < — the kernel's first-wins order."""
    n = origin.x.shape[0]
    tab = sphere_table(centers, radii)
    tmax = _tmax_vector(t_max, n, origin.x)
    t_best = torch.full_like(tmax, FLT_MAX)
    i_best = torch.full((n,), -1, dtype=torch.int32, device=tmax.device)
    for base in range(0, tab.shape[0], S_CHUNK):
        ts = _sphere_ts(origin, direction, tab[base:base + S_CHUNK], t_min,
                        tmax)
        tloc, jloc = torch.min(ts, dim=1)  # first index of the minimum
        better = tloc < t_best
        t_best = torch.where(better, tloc, t_best)
        i_best = torch.where(better, (jloc + base).to(torch.int32), i_best)
    return t_best, i_best


def _spheres_hit_feat_ref(origin, direction, centers, radii, feat, t_min,
                          t_max):
    t, idx = _spheres_hit_ref(origin, direction, centers, radii, t_min, t_max)
    hit = idx >= 0
    rows = feat[idx.clamp_min(0).to(torch.int64)]
    rows = torch.where(hit[:, None], rows, 0.0)
    return t, idx, tuple(rows.t().contiguous().unbind(0))


def _spheres_anyhit_ref(origin, direction, centers, radii, t_min, t_max):
    n = origin.x.shape[0]
    tab = sphere_table(centers, radii)
    tmax = _tmax_vector(t_max, n, origin.x)
    occ = torch.zeros((n,), dtype=torch.bool, device=tmax.device)
    for base in range(0, tab.shape[0], S_CHUNK):
        ts = _sphere_ts(origin, direction, tab[base:base + S_CHUNK], t_min,
                        tmax)
        occ = occ | (ts < FLT_MAX).any(dim=1)
    return occ


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("spheres")
    fn = lib.spheres_hit_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * 8 + [ctypes.c_int, p,
                                                  ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_float] + [p] * 5
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, a: torch.Tensor, device, dtype, shape) -> None:
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, expected {device}")
    if a.dtype != dtype:
        raise TypeError(f"{name} is {a.dtype}, expected {dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                         f"{tuple(shape)}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(mode: int, origin: V3, direction: V3, centers: V3,
            radii: torch.Tensor, t_min: float, t_max, feat=None):
    """Check the inputs, allocate the outputs and launch one mode of the
    kernel on the current stream."""
    global LAUNCHES
    dev = origin.x.device
    n = origin.x.shape[0]
    f32 = torch.float32
    for name, a in zip(("ox", "oy", "oz", "dx", "dy", "dz"),
                       (*origin, *direction)):
        _check(name, a, dev, f32, (n,))
    tmax = _tmax_vector(t_max, n, origin.x)
    _check("t_max", tmax, dev, f32, (n,))
    tab = sphere_table(centers, radii).contiguous()
    s = tab.shape[0]
    _check("spheres", tab, dev, f32, (s, 4))
    if tab.data_ptr() % 16:
        raise ValueError("sphere table must be 16-byte aligned (float4)")
    n_c = 0
    if feat is not None:
        n_c = feat.shape[1]
        _check("feat", feat, dev, f32, (s, n_c))

    ptr = lambda a: None if a is None else a.data_ptr()
    t_out = idx_out = f_out = occ_out = None
    if mode == _ANY_HIT:
        occ_out = torch.empty((n,), dtype=torch.bool, device=dev)
    else:
        t_out = torch.empty((n,), dtype=f32, device=dev)
        idx_out = torch.empty((n,), dtype=torch.int32, device=dev)
        if mode == _FEATURES:
            f_out = torch.empty((n_c, n), dtype=f32, device=dev)
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().spheres_hit_launch(
                mode, *(a.data_ptr() for a in (*origin, *direction)),
                tmax.data_ptr(), tab.data_ptr(), s, ptr(feat), n_c, n,
                float(t_min), ptr(t_out), ptr(idx_out), ptr(f_out),
                ptr(occ_out), stream)
        if rc != 0:
            raise RuntimeError(f"spheres kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES += 1
    if mode == _ANY_HIT:
        return occ_out
    if mode == _FEATURES:
        return t_out, idx_out, tuple(f_out.unbind(0))
    return t_out, idx_out


def _on_cuda(origin: V3) -> bool:
    dev = origin.x.device
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no intersection kernel for tensors on {dev}")


# ---------------------------------------------------------------------------
# public entry points (names of the JAX package's)
# ---------------------------------------------------------------------------


def spheres_hit_feat(origin: V3, direction: V3, centers: V3,
                     radii: torch.Tensor, feat: torch.Tensor, t_min: float,
                     t_max) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """Nearest sphere hit + the winner's feature row.

    origin/direction: V3 of [N]; centers: V3 of [S]; radii [S]; feat
    [S, C] per-sphere features; t_max a float or [N]. Returns (t [N],
    idx [N] int32, feats: tuple of C [N] tensors, zero on a miss).
    """
    if _on_cuda(origin):
        return _launch(_FEATURES, origin, direction, centers, radii, t_min,
                       t_max, feat)
    return _spheres_hit_feat_ref(origin, direction, centers, radii, feat,
                                 t_min, t_max)


def spheres_hit_soa(origin: V3, direction: V3, centers: V3,
                    radii: torch.Tensor, t_min: float,
                    t_max) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest sphere hit: (t [N] with FLT_MAX on a miss, idx [N] int32,
    −1 on a miss)."""
    if _on_cuda(origin):
        return _launch(_NEAREST, origin, direction, centers, radii, t_min,
                       t_max)
    return _spheres_hit_ref(origin, direction, centers, radii, t_min, t_max)


def spheres_anyhit_soa(origin: V3, direction: V3, centers: V3,
                       radii: torch.Tensor, t_min: float,
                       t_max) -> torch.Tensor:
    """[N] bool: any sphere hit in (t_min, t_max) — the shadow test."""
    if _on_cuda(origin):
        return _launch(_ANY_HIT, origin, direction, centers, radii, t_min,
                       t_max)
    return _spheres_anyhit_ref(origin, direction, centers, radii, t_min,
                               t_max)
