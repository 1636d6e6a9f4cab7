"""Nearest / any ray-triangle hit over the heap BVH with the MXU-leaf test
(``config.mx_leaf``): the CUDA kernel ``csrc/bvh_mx.cu`` and its plain
PyTorch version (counterpart of ``tpu_pathtracer/ops/pallas_bvh_mx.py``:
``_kernel_nearest_mx`` through ``packet_trace_mx``, ``_kernel_shadow_mx``
through ``packet_occluded_mx``, and the ``_exact_winner`` post-pass).

The walk is the heap kernel's (``ops/cuda_bvh.py``); at a leaf the four
Möller–Trumbore numerators of every slot come from the ray's feature
vector F = [d, o', o'×d, 1] against the slot's test columns G, each split
into bf16 parts (3 or 6 passes), which is how the TPU kernel runs the
leaf test on its matrix unit. :func:`mx_tables` splits G once a render
(``MxTables.parts``, the kernel's input); the plain version splits the
f32 G itself. That test only picks the winner: t, u, v
and the features are then recomputed in exact f32 from the winner's id
(:func:`exact_winner`). The contract and the summation order are in
``csrc/bvh_mx.cu``; kernel and plain version agree bit for bit (winner,
the kernel's t, occlusion and per-ray counters).

The public functions dispatch on the device of their inputs: tensors on
the CPU go to the plain version, tensors on a CUDA device to the kernel
(or the call raises). There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as _cb
from tpu_pathtracer_torch.ops.cuda_spheres import _on_cuda, _tmax_vector
from tpu_pathtracer_torch.ops.v3 import V3

# Kernel launches by the wrappers below, per mode. Callers reset them to
# 0 and read them back to show that a run went through the kernel.
LAUNCHES = {"nearest": 0, "any_hit": 0}

_NEAREST, _ANY_HIT = 0, 1  # csrc/bvh_mx.cu Mode
_MODE_NAMES = {_NEAREST: "nearest", _ANY_HIT: "any_hit"}
PASSES = (3, 6)

# The [T, 20] test-column row of a slot: the entries of the TPU kernel's
# [16, 4w] G block (pallas_bvh_mx.build_packet_mx) that are not zero by
# construction, with the F rows each multiplies (F = d1 d2 d3, o'1 o'2
# o'3, c1 c2 c3 = o'×d, 1 as rows 0-9). Column 19 is padding.
#   a  = -(d·n):          cols 0-2  = -n            x F rows 0-2
#   ta =  o'·n - v0'·n:   cols 3-5  = n, col 6 = -(v0'·n)  x F rows 3-5, 9
#   ua =  q·e2:           cols 7-9  = v0'×e2, 10-12 = e2   x F rows 0-2, 6-8
#   va = -(q·e1):         cols 13-15 = -(v0'×e1), 16-18 = -e1  x the same
G_COLUMNS = 20
# A slot's row of G's bf16 parts, the kernel's table: _split3's hi, mid
# and lo of the G_COLUMNS entries side by side, then zeros (128 B a slot).
PART_COLUMNS = 64
_GROUPS = ((slice(0, 3), (0, 1, 2)),
           (slice(3, 7), (3, 4, 5, 9)),
           (slice(7, 13), (0, 1, 2, 6, 7, 8)),
           (slice(13, 19), (0, 1, 2, 6, 7, 8)))
_LEAF_CHUNK = 8192  # lanes a plain leaf test handles at once


class MxTables(NamedTuple):
    """The heap BVH of a mesh with the MXU-leaf test columns."""
    heap: _cb.HeapTables   # node table, and tri_feat for the exact recompute
    g: torch.Tensor        # [T, 20] f32 test columns (G_COLUMNS)
    center: torch.Tensor   # [3] f32 recentering of G and of the rays
    parts: torch.Tensor    # [T, 64] bf16 G parts (PART_COLUMNS), the kernel's
    center_xyz: Tuple[float, float, float]  # center's values, read once


def pow2_center(c: torch.Tensor) -> torch.Tensor:
    """Each coordinate rounded to the nearest power of two, kept signed,
    or 0 below 0.5 (``pallas_bvh_mx._pow2_center``): subtracting it from
    a nearby coordinate is mostly exact."""
    a = torch.abs(c)
    p = torch.sign(c) * torch.exp2(torch.round(torch.log2(
        torch.clamp_min(a, 1e-30))))
    return torch.where(a < 0.5, 0.0, p).to(torch.float32)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b of [T, 3] rows, in jnp.cross's operation order."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def mx_tables(mesh) -> MxTables:
    """The kernel's tables of ``mesh`` (a MeshData), on its device:
    ``build_packet_mx``'s G with clusters of one leaf (prims_per_leaf
    slots), centred on the root box's pow2-rounded centre."""
    heap = _cb.heap_tables(mesh)
    center = pow2_center((mesh.bvh_min[1] + mesh.bvh_max[1]) * 0.5)
    f = heap.tri_feat  # n, tc0..5, mid, v0, e1, e2; sentinels zeroed
    n, v0, e1, e2 = f[:, 0:3], f[:, 10:13], f[:, 13:16], f[:, 16:19]
    v0p = v0 - center
    k = -((v0p[:, 0] * n[:, 0] + v0p[:, 1] * n[:, 1]) + v0p[:, 2] * n[:, 2])
    g = torch.cat([-n, n, k[:, None], _cross(v0p, e2), e2,
                   -_cross(v0p, e1), -e1, torch.zeros_like(k)[:, None]],
                  dim=1).contiguous()
    return MxTables(heap, g, center, g_parts(g), tuple(center.tolist()))


def g_parts(g: torch.Tensor) -> torch.Tensor:
    """[T, PART_COLUMNS] bf16: each test-column row's ``_split3`` parts
    hi, mid and lo side by side, then zeros. Each part is a bf16 value, so
    the cast is exact; at three passes ``_split_g``'s parts are hi and
    mid."""
    pad = g.new_zeros((g.shape[0], PART_COLUMNS - 3 * G_COLUMNS))
    return torch.cat([*_split3(g), pad], dim=1).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# plain PyTorch version: the kernel's walk and leaf arithmetic
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split3(x: torch.Tensor):
    """hi, mid, lo bf16 parts of x, as f32 (``pallas_bvh_mx._split3``)."""
    hi = _bf16(x)
    r1 = x - hi
    mid = _bf16(r1)
    return hi, mid, _bf16(r1 - mid)


def _split_g(g: torch.Tensor, passes: int):
    if passes == 3:
        hi = _bf16(g)
        return hi, _bf16(g - hi), None
    return _split3(g)


def ray_features(origin: V3, direction: V3, center: torch.Tensor):
    """F = [d, o - center, (o - center) × d, 1] of each ray split into bf16
    parts: (hi, mid, lo), each [N, 10] (``pallas_bvh_mx._fmat``)."""
    p1, p2, p3 = (origin.x - center[0], origin.y - center[1],
                  origin.z - center[2])
    d1, d2, d3 = direction
    f = torch.stack([d1, d2, d3, p1, p2, p3, p2 * d3 - p3 * d2,
                     p3 * d1 - p1 * d3, p1 * d2 - p2 * d1,
                     torch.ones_like(d1)], dim=1)
    return _split3(f)


def _sum(gp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """S(x, y): products of gp [M, P, K] and fp [M, K] summed over K in
    ascending order from +0, as the kernel sums them."""
    acc = torch.zeros(gp.shape[:2], dtype=gp.dtype, device=gp.device)
    for k in range(gp.shape[2]):
        acc = acc + gp[..., k] * fp[:, None, k]
    return acc


def numerators(rows: torch.Tensor, fparts, passes: int):
    """(a, tn, un, vn), each [M, P], of rays with F parts ``fparts``
    ([M, 10] each) against test-column rows [M, P, 20]."""
    out = []
    for cols, frows in _GROUPS:
        gh, gm, gl = _split_g(rows[..., cols], passes)
        fh, fm, fl = (None if p is None else p[:, list(frows)]
                      for p in fparts)
        hh, hm, mh = _sum(gh, fh), _sum(gh, fm), _sum(gm, fh)
        if passes == 3:
            out.append(hh + (hm + mh))
            continue
        n = hh
        n = n + (hm + mh)
        out.append(n + ((_sum(gh, fl) + _sum(gl, fh)) + _sum(gm, fm)))
    return out


def leaf_step(rows: torch.Tensor, fparts, t_min: float,
              closest: torch.Tensor, passes: int):
    """One leaf visit of M rays over K slots each (test-column rows
    [M, K, 20]): the accept test against ``closest`` and the first minimum
    (``pallas_bvh_mx.py:249-262``). Returns what ``cuda_bvh.leaf_step``
    returns: (hit, new closest, winning column, first column hit)."""
    a, tn, un, vn = numerators(rows, fparts, passes)
    f = 1.0 / a
    t = tn * f
    u = un * f
    v = vn * f
    bad = ((torch.abs(a) < 1e-7) | (torch.minimum(u, v) < 0.0)
           | (u + v > 1.0) | ~(t > t_min) | ~(t < closest[:, None]))
    ok = ~bad
    tloc, j = torch.min(torch.where(ok, t, float("inf")), dim=1)
    hit = ok.any(dim=1)
    first = ok.to(torch.uint8).argmax(dim=1)
    return hit, torch.where(hit, tloc, closest), j, first


def _mx_walk_ref(origin: V3, direction: V3, tmax: torch.Tensor,
                 tabs: MxTables, t_min: float, any_hit: bool, passes: int,
                 visits=None):
    """The kernel's walk, every ray a step per pass (``cuda_bvh``'s plain
    walk with this module's leaf test). Returns what
    ``cuda_bvh._heap_walk_ref`` returns."""
    _check_passes(passes)
    fparts = ray_features(origin, direction, tabs.center)
    slots = torch.arange(tabs.heap.prims_per_leaf, device=tmax.device)

    def leaf_test(walk, lanes, base):
        outs = []
        for s in range(0, lanes.numel(), _LEAF_CHUNK):
            ln, bs = lanes[s:s + _LEAF_CHUNK], base[s:s + _LEAF_CHUNK]
            outs.append(leaf_step(tabs.g[bs[:, None] + slots],
                                  [p[ln] for p in fparts], t_min,
                                  walk.closest[ln], passes))
        return [torch.cat(x) for x in zip(*outs)]

    return _cb._heap_walk_ref(origin, direction, tmax, tabs.heap, t_min,
                              any_hit, visits=visits, leaf_test=leaf_test)


def _check_passes(passes: int) -> None:
    if passes not in PASSES:
        raise ValueError(f"mx_passes must be 3 or 6, got {passes}")


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("bvh_mx")
    fn = lib.bvh_mx_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([i, i] + [p] * 9 + [i, i, f, f, f, f, i]
                       + [p] * 5)
        fn.restype = ctypes.c_int
    return lib


def _launch(mode: int, origin: V3, direction: V3, tmax: torch.Tensor,
            tabs: MxTables, t_min: float, passes: int):
    """Check the inputs, allocate the outputs and launch one mode of the
    kernel on the current stream: no host sync (the centre's values come
    with the tables)."""
    _check_passes(passes)
    heap = tabs.heap
    if tabs.parts.shape[1:] != (PART_COLUMNS,):
        raise ValueError(f"G-part rows must be [T, {PART_COLUMNS}]")
    dev, n = _cb.check_walk_inputs(origin, direction, tmax, heap,
                                   tabs.parts, "G-part", torch.bfloat16)
    f32 = torch.float32
    cnt = torch.empty((5, n), dtype=torch.int32, device=dev)
    t_out = tri_out = occ_out = None
    if mode == _ANY_HIT:
        occ_out = torch.empty((n,), dtype=torch.bool, device=dev)
    else:
        t_out = torch.empty((n,), dtype=f32, device=dev)
        tri_out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        ptr = lambda a: None if a is None else a.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().bvh_mx_launch(
                mode, passes,
                *(a.data_ptr() for a in (*origin, *direction, tmax)),
                heap.nodes.data_ptr(), tabs.parts.data_ptr(),
                heap.first_leaf, heap.prims_per_leaf, *tabs.center_xyz,
                float(t_min), n,
                ptr(t_out), ptr(tri_out), ptr(occ_out), cnt.data_ptr(),
                stream)
        if rc != 0:
            raise RuntimeError(f"MXU-leaf BVH kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES[_MODE_NAMES[mode]] += 1
    return t_out, tri_out, occ_out, cnt


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _mx_trace_ref(origin: V3, direction: V3, t_max, tabs: MxTables,
                  t_min: float, passes: int = 3):
    tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
    t, tri, _, cnt = _mx_walk_ref(origin, direction, tmax, tabs, t_min,
                                  False, passes)
    return t, tri, cnt


def _mx_occluded_ref(origin: V3, direction: V3, t_max, tabs: MxTables,
                     t_min: float, passes: int = 3):
    tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
    _, _, occ, cnt = _mx_walk_ref(origin, direction, tmax, tabs, t_min,
                                  True, passes)
    return occ, cnt


def mx_trace(origin: V3, direction: V3, t_max, tabs: MxTables,
             t_min: float, passes: int = 3) -> Tuple[torch.Tensor, ...]:
    """Nearest hit by the split-bf16 leaf test: (the kernel's t [N], the
    ray's t_max on a miss; tri [N] int32 heap slot, -1 on a miss; counters
    [5, N] int32). :func:`exact_winner` turns it into the hit."""
    if _on_cuda(origin):
        tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
        t, tri, _, cnt = _launch(_NEAREST, origin, direction, tmax, tabs,
                                 t_min, passes)
        return t, tri, cnt
    return _mx_trace_ref(origin, direction, t_max, tabs, t_min, passes)


def mx_occluded(origin: V3, direction: V3, t_max, tabs: MxTables,
                t_min: float, passes: int = 3
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any hit in (t_min, t_max) by the split-bf16 leaf test: (occ [N]
    bool, counters [5, N] int32). Lanes with t_max <= 0 test nothing."""
    if _on_cuda(origin):
        tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
        _, _, occ, cnt = _launch(_ANY_HIT, origin, direction, tmax, tabs,
                                 t_min, passes)
        return occ, cnt
    return _mx_occluded_ref(origin, direction, t_max, tabs, t_min, passes)


def exact_winner(origin: V3, direction: V3, t_kernel: torch.Tensor,
                 tri: torch.Tensor, tri_feat: torch.Tensor):
    """``pallas_bvh_mx._exact_winner``, in its operation order: t, u, v,
    the normal, the texture coordinates and the material id of each
    winner recomputed in exact f32 from one row gather of the [T, 19]
    feature table (the index clamped at 0, as a JAX gather clamps). A
    winner whose exact t is not finite keeps the kernel's t and gets
    u = v = 0. Returns (t, tri, u, v, nx, ny, nz, tu, tv, mid int32), the
    tuple of ``cuda_bvh.winner_features``."""
    fr = tri_feat[tri.clamp_min(0).to(torch.int64)]
    nx, ny, nz = fr[:, 0], fr[:, 1], fr[:, 2]
    d1, d2, d3 = direction
    a = -(d1 * nx + d2 * ny + d3 * nz)
    f = 1.0 / torch.where(torch.abs(a) < 1e-7, 1.0, a)
    sx = origin.x - fr[:, 10]
    sy = origin.y - fr[:, 11]
    sz = origin.z - fr[:, 12]
    qx = sy * d3 - sz * d2
    qy = sz * d1 - sx * d3
    qz = sx * d2 - sy * d1
    u = f * (qx * fr[:, 16] + qy * fr[:, 17] + qz * fr[:, 18])
    v = -(f * (qx * fr[:, 13] + qy * fr[:, 14] + qz * fr[:, 15]))
    t = f * (sx * nx + sy * ny + sz * nz)
    ok = (tri >= 0) & torch.isfinite(t)
    t = torch.where(ok, t, t_kernel)
    u = torch.where(ok, u, 0.0)
    v = torch.where(ok, v, 0.0)
    w0 = 1.0 - u - v
    tu = u * fr[:, 5] + v * fr[:, 7] + w0 * fr[:, 3]
    tv = u * fr[:, 6] + v * fr[:, 8] + w0 * fr[:, 4]
    return t, tri, u, v, nx, ny, nz, tu, tv, fr[:, 9].to(torch.int32)
