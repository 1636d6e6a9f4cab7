"""Brute-force nearest / any ray–triangle hit: the CUDA kernel
``csrc/tris.cu`` and its plain PyTorch version (counterpart of
``tpu_pathtracer/ops/pallas_tris.py``).

The public functions dispatch on the device of their inputs: tensors on
the CPU go to the plain version, tensors on a CUDA device to the kernel
(or the call raises). There is no fallback from one to the other.

Contract of all three modes: the restructured Möller–Trumbore with the
face normal n = e1×e2 precomputed (a = −(d·n), f = 1/a, u = f(q·e2),
v = −f(q·e1), t = f(s·n) with s = o − v0, q = s×d); a triangle fails if
|a| < 1e-7, min(u, v) < 0, u + v > 1, !(t > t_min) or !(t < t_best),
where t_best starts at the ray's t_max and triangles are tested in slot
order with a strict <, so the first triangle wins a tie. Any-hit tests
against the ray's own t_max. Sentinel triangles (+inf vertices) fail
through NaN arithmetic. On a miss t = FLT_MAX, idx = −1, u = v = 0 and
the features are 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops.cuda_spheres import (_check, _on_cuda,
                                                   _tmax_vector)
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

# Kernel launches by the wrappers below, per mode. Callers reset them to
# 0 and read them back to show that a run went through the kernel.
LAUNCHES = {"nearest": 0, "features": 0, "any_hit": 0}

_NEAREST, _FEATURES, _ANY_HIT = 0, 1, 2  # csrc/tris.cu Mode
_MODE_NAMES = {_NEAREST: "nearest", _FEATURES: "features",
               _ANY_HIT: "any_hit"}
T_CHUNK = 256  # triangles per pass of the plain version (bounds [N, chunk])


def tri_table(v0: V3, e1: V3, e2: V3, nrm: V3) -> torch.Tensor:
    """[T, 12] float32 rows (v0, e1, e2, n): the kernel's triangle table.
    A fresh allocation, so 16-byte aligned. A caller that launches the
    kernel many times on one mesh builds it once and passes it as
    ``tab`` (``engine.wavefront.make_view``)."""
    return torch.stack([*v0, *e1, *e2, *nrm], dim=1).contiguous()


def _check_table(tab: torch.Tensor, v0: V3, dev) -> None:
    """Raise unless ``tab`` is a [T, 12] float32 table on ``dev`` for the
    T triangles of ``v0``, contiguous and 16-byte aligned (float4)."""
    _check("triangles", tab, dev, torch.float32, (v0.x.shape[0], 12))
    if tab.data_ptr() % 16:
        raise ValueError("triangle table must be 16-byte aligned (float4)")


def _cpu_table(tab: Optional[torch.Tensor], v0: V3, origin: V3) -> None:
    """The CPU path checks a prebuilt table as the kernel's does; the
    plain versions build their own from the columns."""
    if tab is not None:
        _check_table(tab, v0, origin.x.device)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _tri_step(origin: V3, direction: V3, tab: torch.Tensor, t_min: float,
              t_best: torch.Tensor):
    """(t, u, v, bad), each [N, C], of every ray against every triangle of
    the chunk ``tab`` [C, 12]; ``t_best`` [N] bounds t from above. Each
    expression has the kernel's operation order, so the two round alike."""
    v0x, v0y, v0z, g1x, g1y, g1z, g2x, g2y, g2z, n1, n2, n3 = tab.unbind(1)
    o1, o2, o3 = (c[:, None] for c in origin)
    d1, d2, d3 = (c[:, None] for c in direction)
    a = -(d1 * n1 + d2 * n2 + d3 * n3)
    parallel = torch.abs(a) < 1e-7
    f = torch.reciprocal(a)
    sx = o1 - v0x
    sy = o2 - v0y
    sz = o3 - v0z
    qx = sy * d3 - sz * d2
    qy = sz * d1 - sx * d3
    qz = sx * d2 - sy * d1
    u = f * (qx * g2x + qy * g2y + qz * g2z)
    v = -(f * (qx * g1x + qy * g1y + qz * g1z))
    t = f * (sx * n1 + sy * n2 + sz * n3)
    bad = (parallel | (torch.minimum(u, v) < 0.0) | (u + v > 1.0)
           | ~(t > t_min) | ~(t < t_best[:, None]))
    return t, u, v, bad


def _tris_hit_ref(origin, direction, v0, e1, e2, nrm, t_min, t_max):
    """(t, idx, u, v) by chunks over the triangles: the first minimum of
    each chunk, merged by strict < — the kernel's first-wins order."""
    n = origin.x.shape[0]
    tab = tri_table(v0, e1, e2, nrm)
    t_best = _tmax_vector(t_max, n, origin.x)
    i_best = torch.full((n,), -1, dtype=torch.int32, device=t_best.device)
    u_best = torch.zeros_like(t_best)
    v_best = torch.zeros_like(t_best)
    for base in range(0, tab.shape[0], T_CHUNK):
        t, u, v, bad = _tri_step(origin, direction,
                                 tab[base:base + T_CHUNK], t_min, t_best)
        tloc, jloc = torch.min(torch.where(bad, float("inf"), t), dim=1)
        better = tloc < t_best
        j = jloc[:, None]
        t_best = torch.where(better, tloc, t_best)
        i_best = torch.where(better, (jloc + base).to(torch.int32), i_best)
        u_best = torch.where(better, u.gather(1, j)[:, 0], u_best)
        v_best = torch.where(better, v.gather(1, j)[:, 0], v_best)
    hit = i_best >= 0
    return (torch.where(hit, t_best, FLT_MAX), i_best,
            torch.where(hit, u_best, 0.0), torch.where(hit, v_best, 0.0))


def _tris_hit_feat_ref(origin, direction, v0, e1, e2, nrm, feat, t_min,
                       t_max):
    t, idx, u, v = _tris_hit_ref(origin, direction, v0, e1, e2, nrm, t_min,
                                 t_max)
    rows = feat[idx.clamp_min(0).to(torch.int64)]
    rows = torch.where((idx >= 0)[:, None], rows, 0.0)
    return t, idx, u, v, tuple(rows.t().contiguous().unbind(0))


def _tris_anyhit_ref(origin, direction, v0, e1, e2, nrm, t_min, t_max):
    n = origin.x.shape[0]
    tab = tri_table(v0, e1, e2, nrm)
    tmax = _tmax_vector(t_max, n, origin.x)
    occ = torch.zeros((n,), dtype=torch.bool, device=tmax.device)
    for base in range(0, tab.shape[0], T_CHUNK):
        *_, bad = _tri_step(origin, direction, tab[base:base + T_CHUNK],
                            t_min, tmax)
        occ = occ | (~bad).any(dim=1)
    return occ


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("tris")
    fn = lib.tris_hit_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * 8 + [ctypes.c_int, p,
                                                  ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_float] + [p] * 7
        fn.restype = ctypes.c_int
    return lib


def _launch(mode: int, origin: V3, direction: V3, v0: V3, e1: V3, e2: V3,
            nrm: V3, t_min: float, t_max, feat=None, tab=None):
    """Check the inputs, allocate the outputs and launch one mode of the
    kernel on the current stream; ``tab`` the prebuilt table of the
    columns, else built here."""
    dev = origin.x.device
    n = origin.x.shape[0]
    f32 = torch.float32
    for name, a in zip(("ox", "oy", "oz", "dx", "dy", "dz"),
                       (*origin, *direction)):
        _check(name, a, dev, f32, (n,))
    tmax = _tmax_vector(t_max, n, origin.x)
    _check("t_max", tmax, dev, f32, (n,))
    if tab is None:
        tab = tri_table(v0, e1, e2, nrm)
    _check_table(tab, v0, dev)
    t_count = tab.shape[0]
    n_c = 0
    if feat is not None:
        n_c = feat.shape[1]
        _check("feat", feat, dev, f32, (t_count, n_c))

    ptr = lambda a: None if a is None else a.data_ptr()
    t_out = idx_out = u_out = v_out = f_out = occ_out = None
    if mode == _ANY_HIT:
        occ_out = torch.empty((n,), dtype=torch.bool, device=dev)
    else:
        t_out = torch.empty((n,), dtype=f32, device=dev)
        idx_out = torch.empty((n,), dtype=torch.int32, device=dev)
        u_out = torch.empty((n,), dtype=f32, device=dev)
        v_out = torch.empty((n,), dtype=f32, device=dev)
        if mode == _FEATURES:
            f_out = torch.empty((n_c, n), dtype=f32, device=dev)
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().tris_hit_launch(
                mode, *(a.data_ptr() for a in (*origin, *direction)),
                tmax.data_ptr(), tab.data_ptr(), t_count, ptr(feat), n_c, n,
                float(t_min), ptr(t_out), ptr(idx_out), ptr(u_out),
                ptr(v_out), ptr(f_out), ptr(occ_out), stream)
        if rc != 0:
            raise RuntimeError(f"triangle kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES[_MODE_NAMES[mode]] += 1
    if mode == _ANY_HIT:
        return occ_out
    if mode == _FEATURES:
        return t_out, idx_out, u_out, v_out, tuple(f_out.unbind(0))
    return t_out, idx_out, u_out, v_out


# ---------------------------------------------------------------------------
# public entry points (names of the JAX package's)
# ---------------------------------------------------------------------------


def tris_hit_feat(origin: V3, direction: V3, v0: V3, e1: V3, e2: V3,
                  nrm: V3, feat: torch.Tensor, t_min: float, t_max, *,
                  tab: Optional[torch.Tensor] = None):
    """Nearest triangle hit + the winner's feature row.

    origin/direction: V3 of [N]; v0/e1/e2/nrm: V3 of [T] (nrm = e1×e2);
    feat [T, C]; t_max a float or [N]; ``tab`` the columns'
    :func:`tri_table`, if the caller built it (checked, not compared).
    Returns (t, idx int32, u, v, feats: tuple of C [N] tensors, zero on a
    miss).
    """
    if _on_cuda(origin):
        return _launch(_FEATURES, origin, direction, v0, e1, e2, nrm, t_min,
                       t_max, feat, tab)
    _cpu_table(tab, v0, origin)
    return _tris_hit_feat_ref(origin, direction, v0, e1, e2, nrm, feat,
                              t_min, t_max)


def tris_hit_soa(origin: V3, direction: V3, v0: V3, e1: V3, e2: V3,
                 nrm: V3, t_min: float, t_max, *,
                 tab: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Nearest triangle hit: (t [N] with FLT_MAX on a miss, idx [N] int32,
    −1 on a miss, u, v)."""
    if _on_cuda(origin):
        return _launch(_NEAREST, origin, direction, v0, e1, e2, nrm, t_min,
                       t_max, tab=tab)
    _cpu_table(tab, v0, origin)
    return _tris_hit_ref(origin, direction, v0, e1, e2, nrm, t_min, t_max)


def tris_anyhit_soa(origin: V3, direction: V3, v0: V3, e1: V3, e2: V3,
                    nrm: V3, t_min: float, t_max, *,
                    tab: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] bool: any triangle hit in (t_min, t_max) — the shadow test."""
    if _on_cuda(origin):
        return _launch(_ANY_HIT, origin, direction, v0, e1, e2, nrm, t_min,
                       t_max, tab=tab)
    _cpu_table(tab, v0, origin)
    return _tris_anyhit_ref(origin, direction, v0, e1, e2, nrm, t_min,
                            t_max)
