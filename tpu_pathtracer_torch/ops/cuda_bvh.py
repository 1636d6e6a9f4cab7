"""Nearest / any ray-triangle hit over the implicit-heap BVH: the CUDA
kernel ``csrc/bvh.cu`` and its plain PyTorch version (counterpart of
``tpu_pathtracer/ops/pallas_bvh.py``: ``_kernel_nearest`` through
``packet_trace``, ``_kernel_shadow`` through ``packet_occluded``, and the
``winner_features`` post-pass).

The public functions dispatch on the device of their inputs: tensors on
the CPU go to the plain version, tensors on a CUDA device to the kernel
(or the call raises). There is no fallback from one to the other.

Both follow one walk per ray, the reference's dual-node bitstack descent
(``hitBvh``, kernels.cu:148–224), step for step, so t, the winning slot,
occlusion and the per-ray counters agree bit for bit between them. The
contract is spelled out in ``csrc/bvh.cu``. The JAX package's packet
kernels visit nodes in another order (majority votes over 1024 rays), so
against them t and the hit mask agree, winner ids agree where t is
unique, and the counters mean something else (they count per packet).

Per-ray counters are int32 [5, N]: nodes_both, nodes_single, leaf_visits,
leaf_pop, node_steps (see ``COUNTERS``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops.bvh4 import TRI_COLUMNS
from tpu_pathtracer_torch.ops.cuda_spheres import _check, _on_cuda, \
    _tmax_vector
from tpu_pathtracer_torch.ops.intersect import BBOX_T_MIN
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

# Kernel launches by the wrappers below, per mode. Callers reset them to
# 0 and read them back to show that a run went through the kernel.
LAUNCHES = {"nearest": 0, "any_hit": 0}

COUNTERS = ("nodes_both", "nodes_single", "leaf_visits", "leaf_pop",
            "node_steps")
_NEAREST, _ANY_HIT = 0, 1  # csrc/bvh.cu Mode
_MODE_NAMES = {_NEAREST: "nearest", _ANY_HIT: "any_hit"}


class HeapTables(NamedTuple):
    """The heap BVH of a mesh in the layout the kernel reads."""
    nodes: torch.Tensor     # [2*first_leaf, 8] f32: min xyz, max xyz, 0, 0
    tri: torch.Tensor       # [T, 12] f32 rows v0, e1, e2, n = e1×e2;
    # sentinel (non-finite) slots are zero rows
    tri_feat: torch.Tensor  # [T, 19] winner features: n, tc0..5, mid, v0,
    # e1, e2 (the JAX package's build_packet_mesh layout)
    first_leaf: int
    prims_per_leaf: int


def heap_tables(mesh) -> HeapTables:
    """The kernel's tables of ``mesh`` (a MeshData), on its device."""
    fl = mesh.first_leaf
    if max(fl, 1).bit_length() > 32:
        raise ValueError("BVH deeper than the 32-level uint32 bitstack")
    n_nodes = 2 * fl
    bmin, bmax = mesh.bvh_min[:n_nodes], mesh.bvh_max[:n_nodes]
    nodes = torch.cat([bmin, bmax, torch.zeros_like(bmin[:, :2])], dim=1)
    # non-finite (sentinel) slots become zero rows; n = e1×e2 in the JAX
    # package's order (pallas_bvh._tri_components)
    sane = torch.isfinite(mesh.v0).all(dim=1, keepdim=True)
    z = torch.zeros_like(mesh.v0)
    v0 = torch.where(sane, mesh.v0, z)
    e1 = torch.where(sane, mesh.v1 - mesh.v0, z)
    e2 = torch.where(sane, mesh.v2 - mesh.v0, z)
    nrm = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                       e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                       e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    tri_feat = torch.cat([nrm, mesh.tex_coords,
                          mesh.mesh_id.to(torch.float32)[:, None], v0, e1,
                          e2], dim=1).contiguous()
    return HeapTables(nodes.contiguous(),
                      tri_feat[:, TRI_COLUMNS].contiguous(), tri_feat, fl,
                      mesh.prims_per_leaf)


# ---------------------------------------------------------------------------
# plain PyTorch version: the kernel's walk, all rays a step at a time
# ---------------------------------------------------------------------------


def slab_entry(mn: torch.Tensor, mx: torch.Tensor, o: torch.Tensor,
               inv: torch.Tensor, neg: torch.Tensor,
               closest: torch.Tensor) -> torch.Tensor:
    """Entry distance into boxes ``mn``/``mx`` [..., 3] of rays ``o``,
    ``inv`` = 1/d, ``neg`` = inv < 0 ([..., 3]), or FLT_MAX on a miss:
    ``pt::slab_entry`` (csrc/bvh_common.cuh), where-form compares."""
    t0 = (mn - o) * inv
    t1 = (mx - o) * inv
    lo = torch.where(neg, t1, t0)
    hi = torch.where(neg, t0, t1)
    tmin = torch.full_like(closest, BBOX_T_MIN)
    tmax = closest
    for a in range(3):
        tmin = torch.where(lo[..., a] > tmin, lo[..., a], tmin)
        tmax = torch.where(hi[..., a] < tmax, hi[..., a], tmax)
    return torch.where(tmax < tmin, FLT_MAX, tmin)


def mt_rows(rows: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
            t_min: float, t_best: torch.Tensor):
    """``pt::mt_hit`` of rays ``o``/``d`` [M, 3] against triangle rows
    [M, K, 12]; ``t_best`` [M]. Returns (t, hit), each [M, K]."""
    v0x, v0y, v0z, g1x, g1y, g1z, g2x, g2y, g2z, n1, n2, n3 = \
        rows.unbind(2)
    o1, o2, o3 = (c[:, None] for c in o.unbind(1))
    d1, d2, d3 = (c[:, None] for c in d.unbind(1))
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
    return t, ~bad


def leaf_step(rows: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
              t_min: float, closest: torch.Tensor):
    """One leaf visit of M rays over K slots each ([M, K, 12]), slots in
    order with strict <: the first minimum among the hits wins, which is
    what the kernel's sequential loop keeps. Returns (hit [M], new
    closest [M], winning column [M], first column hit [M], which ends an
    any-hit walk)."""
    t, ok = mt_rows(rows, o, d, t_min, closest)
    tloc, j = torch.min(torch.where(ok, t, float("inf")), dim=1)
    hit = ok.any(dim=1)
    first = ok.to(torch.uint8).argmax(dim=1)
    return hit, torch.where(hit, tloc, closest), j, first


def _ctz32(x: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of nonzero values below 2^32 (int64)."""
    n = torch.zeros_like(x)
    for half, mask in ((16, 0xFFFF), (8, 0xFF), (4, 0xF), (2, 0x3),
                       (1, 0x1)):
        zero = (x & mask) == 0
        n = n + torch.where(zero, half, 0)
        x = torch.where(zero, x >> half, x)
    return n


def _heap_walk_ref(origin: V3, direction: V3, tmax: torch.Tensor,
                   tabs: HeapTables, t_min: float, any_hit: bool,
                   visits: Optional[dict] = None):
    """(closest [N], tri [N] int32, occ [N] bool, counters [5, N] int32):
    the kernel's walk with every ray advancing one step per pass; with
    ``any_hit``, tri is the slot whose hit ended the walk. ``visits``, if
    given, gathers the ids of the node boxes (``visits["nodes"]``) and
    leaves (``visits["leaves"]``) the walk reads, a tensor of each a
    pass."""
    o = origin.stack()
    d = direction.stack()
    inv = 1.0 / d
    neg = inv < 0.0
    n = o.shape[0]
    dev = o.device
    fl, P = tabs.first_leaf, tabs.prims_per_leaf
    closest = tmax.clone()
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    cnt = torch.zeros((5, n), dtype=torch.int64, device=dev)
    idx = torch.where(closest > 0.0, 1, 0).to(torch.int64)
    bs = torch.ones((n,), dtype=torch.int64, device=dev)
    slots = torch.arange(P, device=dev)

    def pop(lanes):
        b, i = bs[lanes], idx[lanes]
        m = _ctz32(b)
        bs[lanes] = (b >> m) ^ 1
        idx[lanes] = (i >> m) ^ 1

    while True:
        lanes = (idx > 0).nonzero().flatten()
        if lanes.numel() == 0:
            break
        is_leaf = idx[lanes] >= fl
        inner, leaf = lanes[~is_leaf], lanes[is_leaf]
        if inner.numel():
            c = closest[inner]
            l = idx[inner] * 2
            pair = torch.stack([l, l + 1], dim=1)
            if visits is not None:
                visits["nodes"].append(pair.flatten())
            box = tabs.nodes[pair]  # [M, 2, 8]
            h = slab_entry(box[..., 0:3], box[..., 3:6], o[inner][:, None],
                           inv[inner][:, None], neg[inner][:, None],
                           c[:, None].expand(-1, 2))
            lh, rh = h[:, 0], h[:, 1]
            tl, tr = lh < c, rh < c
            both, single = tl & tr, tl ^ tr
            child = l + (rh < lh).to(torch.int64)
            cnt[0, inner] += both.to(torch.int64)
            cnt[1, inner] += single.to(torch.int64)
            cnt[4, inner] += 1
            go = both | single
            b = bs[inner]
            bs[inner] = torch.where(both, (b << 1) | 1,
                                    torch.where(single, b << 1, b))
            idx[inner] = torch.where(go, child, idx[inner])
            pop(inner[~go])
        if leaf.numel():
            if visits is not None:
                visits["leaves"].append(idx[leaf] - fl)
            base = (idx[leaf] - fl) * P
            rows = tabs.tri[base[:, None] + slots]  # [M, P, 12]
            hit, new_c, j, first = leaf_step(rows, o[leaf], d[leaf], t_min,
                                             closest[leaf])
            cnt[2, leaf] += 1
            if any_hit:
                # the walk ends at the first slot hit
                occ[leaf] = hit
                best[leaf] = torch.where(hit, base + first, best[leaf])
                idx[leaf[hit]] = 0
                leaf = leaf[~hit]
            else:
                closest[leaf] = new_c
                best[leaf] = torch.where(hit, base + j, best[leaf])
            pop(leaf)
    return closest, best.to(torch.int32), occ, cnt.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("bvh")
    fn = lib.bvh_heap_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([ctypes.c_int] + [p] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int] + [p] * 5)
        fn.restype = ctypes.c_int
    return lib


def _launch(mode: int, origin: V3, direction: V3, tmax: torch.Tensor,
            tabs: HeapTables, t_min: float):
    """Check the inputs, allocate the outputs and launch one mode of the
    kernel on the current stream."""
    dev = origin.x.device
    n = origin.x.shape[0]
    f32 = torch.float32
    for name, a in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t_max"),
                       (*origin, *direction, tmax)):
        _check(name, a, dev, f32, (n,))
    _check("nodes", tabs.nodes, dev, f32, (2 * tabs.first_leaf, 8))
    t_count = tabs.tri.shape[0]
    _check("triangles", tabs.tri, dev, f32, (t_count, 12))
    if t_count < tabs.first_leaf * tabs.prims_per_leaf:
        raise ValueError(f"{t_count} triangle slots do not cover "
                         f"{tabs.first_leaf} leaves of "
                         f"{tabs.prims_per_leaf}")
    if tabs.nodes.data_ptr() % 16 or tabs.tri.data_ptr() % 16:
        raise ValueError("node and triangle tables must be 16-byte aligned "
                         "(float4)")
    if max(tabs.first_leaf, 1).bit_length() > 32:
        raise ValueError("BVH deeper than the 32-level uint32 bitstack")
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
            rc = _lib().bvh_heap_launch(
                mode, *(a.data_ptr() for a in (*origin, *direction, tmax)),
                tabs.nodes.data_ptr(), tabs.tri.data_ptr(), tabs.first_leaf,
                tabs.prims_per_leaf, float(t_min), n, ptr(t_out),
                ptr(tri_out), ptr(occ_out), cnt.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"heap BVH kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES[_MODE_NAMES[mode]] += 1
    return t_out, tri_out, occ_out, cnt


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _heap_trace_ref(origin: V3, direction: V3, t_max, tabs: HeapTables,
                    t_min: float):
    tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
    t, tri, _, cnt = _heap_walk_ref(origin, direction, tmax, tabs, t_min,
                                    any_hit=False)
    return t, tri, cnt


def _heap_occluded_ref(origin: V3, direction: V3, t_max, tabs: HeapTables,
                       t_min: float):
    tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
    _, _, occ, cnt = _heap_walk_ref(origin, direction, tmax, tabs, t_min,
                                    any_hit=True)
    return occ, cnt


def heap_trace(origin: V3, direction: V3, t_max, tabs: HeapTables,
               t_min: float) -> Tuple[torch.Tensor, ...]:
    """Nearest hit: (t [N], the ray's t_max on a miss; tri [N] int32 heap
    slot, -1 on a miss; counters [5, N] int32)."""
    if _on_cuda(origin):
        tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
        t, tri, _, cnt = _launch(_NEAREST, origin, direction, tmax, tabs,
                                 t_min)
        return t, tri, cnt
    return _heap_trace_ref(origin, direction, t_max, tabs, t_min)


def heap_occluded(origin: V3, direction: V3, t_max, tabs: HeapTables,
                  t_min: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any hit in (t_min, t_max): (occ [N] bool, counters [5, N] int32).
    Lanes with t_max <= 0 test nothing."""
    if _on_cuda(origin):
        tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
        _, _, occ, cnt = _launch(_ANY_HIT, origin, direction, tmax, tabs,
                                 t_min)
        return occ, cnt
    return _heap_occluded_ref(origin, direction, t_max, tabs, t_min)


def winner_features(origin: V3, direction: V3, t: torch.Tensor,
                    tri: torch.Tensor, tri_feat: torch.Tensor):
    """The JAX package's ``winner_features`` post-pass, in its operation
    order: one row gather of the [T, 19] feature table and u, v recomputed
    from the gathered v0, e1, e2. Misses gather row 0 and get u = v = 0.
    Returns (t, tri, u, v, nx, ny, nz, tu, tv, mid int32)."""
    fr = tri_feat[tri.clamp_min(0).to(torch.int64)]
    nx, ny, nz = fr[:, 0], fr[:, 1], fr[:, 2]
    mid = fr[:, 9].to(torch.int32)
    hit = tri >= 0
    a = -(direction.x * nx + direction.y * ny + direction.z * nz)
    f_inv = 1.0 / torch.where(torch.abs(a) < 1e-30, 1.0, a)
    sx = origin.x - fr[:, 10]
    sy = origin.y - fr[:, 11]
    sz = origin.z - fr[:, 12]
    qx = sy * direction.z - sz * direction.y
    qy = sz * direction.x - sx * direction.z
    qz = sx * direction.y - sy * direction.x
    u = f_inv * (qx * fr[:, 16] + qy * fr[:, 17] + qz * fr[:, 18])
    v = -(f_inv * (qx * fr[:, 13] + qy * fr[:, 14] + qz * fr[:, 15]))
    u = torch.where(hit, u, 0.0)
    v = torch.where(hit, v, 0.0)
    w0 = 1.0 - u - v
    tu = u * fr[:, 5] + v * fr[:, 7] + w0 * fr[:, 3]
    tv = u * fr[:, 6] + v * fr[:, 8] + w0 * fr[:, 4]
    return (t, tri, u, v, nx, ny, nz, tu, tv, mid)
