"""Wavefront path-tracing stages (component-SoA) + the plain batch engine
(counterpart of ``tpu_pathtracer/engine/wavefront.py``).

A batch of N paths advances one bounce per call of :func:`bounce_step`;
each stage (intersect, scatter, roulette) is a masked elementwise pass
over dense ``[N]`` component tensors. Sphere intersection goes through
:func:`tpu_pathtracer_torch.ops.cuda_spheres.spheres_hit_feat`; the
shadow rays through the any-hit modes. A triangle mesh takes one of four
tiers (:func:`mesh_tier`), as the JAX package dispatches on a TPU:

  * ``bvh4``: a mesh above ``packet_threshold`` triangle slots with SAH
    BVH4 tables and ``config.bvh4`` — ``ops/cuda_bvh4.py``;
  * ``heap``: any other mesh above ``packet_threshold``, or above
    ``TRI_BRUTE_MAX`` — the heap BVH walk ``ops/cuda_bvh.py``;
  * ``brute``: a smaller mesh — ``ops/cuda_tris.py``;
  * ``oracle``: ``use_bvh=False`` — the all-triangles scan
    :func:`tpu_pathtracer_torch.ops.bvh.brute_force`.

Each runs its CUDA kernel for tensors on the GPU and its plain version
on the CPU. The two BVH tiers trace one ray per thread, in lane order.

Radiance accumulation reproduces the reference:
  * miss → ``color += attenuation * sky`` and the path ends;
  * a specular hit of the light ends the path, adding
    ``attenuation * lightColor`` only when NEE is off;
  * NEE adds the light's contribution with the attenuation after the
    scatter update (kernels.cu:487 before :493);
  * roulette from bounce ``rr_start_bounce + 1`` with survival
    probability max(attenuation).

The TPU schedule knobs of the JAX package's packet kernels
(``packet_packs``, ``packet_split``, ``oct``, ``prefetch``, ``pair_pf``,
``leaf_cull``, ``tree_min``, ``packet_scratch``, ``bvh4_pf``,
``bvh4_spec``, ``bvh4_pair``, ``bvh4_scratch``, ``packet_width``, and the
coherence sort ``sort_rays``/``shadow_sort``) change how a packet of rays
is scheduled, not what it hits; a per-ray walk has no packets, so they
have no effect here. (Sorting the rays by the JAX package's key before
the CUDA walk was measured on an H100 and gained nothing: ROADMAP A-12.)
The knobs that change results (``fast_math``, ``mx_leaf``, ``regroup``)
are not ported and raise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from tpu_pathtracer_torch.camera import Camera
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.models import scene as sc
from tpu_pathtracer_torch.models.scene import Scene
from tpu_pathtracer_torch.ops import bvh as _bvh
from tpu_pathtracer_torch.ops import cuda_bvh as _cb
from tpu_pathtracer_torch.ops import cuda_bvh4 as _cb4
from tpu_pathtracer_torch.ops import cuda_spheres as _cs
from tpu_pathtracer_torch.ops import cuda_tris as _ct
from tpu_pathtracer_torch.ops import materials as _m
from tpu_pathtracer_torch.ops import rng as _rng
from tpu_pathtracer_torch.ops.v3 import V3, where as vwhere
from tpu_pathtracer_torch.ops.intersect import BBOX_T_MIN
from tpu_pathtracer_torch.ops.vec import FLT_MAX

TRI_BRUTE_MAX = 16384  # the JAX package's largest brute-force mesh
# knobs of the JAX package's heap packet kernels that change results;
# not ported (ROADMAP queue B, slice 5b)
_UNPORTED_KNOBS = ("fast_math", "mx_leaf", "regroup")


def _use_packet(scene: Scene, config: RenderConfig) -> bool:
    """The JAX package's packet-path rule: ``use_bvh`` and more than
    ``packet_threshold`` triangle slots, on a heap with a power-of-two
    leaf row."""
    if not (scene.has_mesh and config.use_bvh):
        return False
    fl = scene.mesh.first_leaf
    thresh = config.packet_threshold or TRI_BRUTE_MAX
    return scene.mesh.num_tris > thresh and fl & (fl - 1) == 0


def mesh_tier(scene: Scene, config: RenderConfig) -> str:
    """Which intersection the mesh takes: "bvh4", "heap", "brute" or
    "oracle" ("" without a mesh). Large meshes off the packet path take
    the heap walk, which is the JAX package's ``traverse``."""
    if not scene.has_mesh:
        return ""
    if not config.use_bvh:
        return "oracle"
    if _use_packet(scene, config):
        return "bvh4" if (config.bvh4 and scene.mesh.bvh4 is not None) \
            else "heap"
    return "heap" if scene.mesh.num_tris > TRI_BRUTE_MAX else "brute"


def check_supported(scene: Scene, config: RenderConfig) -> None:
    """Raise for a knob that would change the image and is not ported:
    ``fast_math``, ``mx_leaf`` and ``regroup`` select other kernels for a
    heap-tier mesh on the JAX package's packet path (slice 5b)."""
    if _use_packet(scene, config) and mesh_tier(scene, config) == "heap":
        for knob in _UNPORTED_KNOBS:
            if getattr(config, knob):
                raise NotImplementedError(
                    f"slice 5b: {knob}=True selects a JAX packet kernel "
                    "variant that is not ported yet")


class MatCols(NamedTuple):
    """Per-lane material columns of the surface each lane hit."""
    mtype: torch.Tensor        # [N] int32
    color: V3
    color2: V3
    param: torch.Tensor
    param2: torch.Tensor
    absorption: V3
    scatter_dist: torch.Tensor
    tex_id: torch.Tensor       # [N] int32

    @staticmethod
    def zeros(n: int, device) -> "MatCols":
        z = torch.zeros((n,), device=device)
        zi = torch.zeros((n,), dtype=torch.int32, device=device)
        return MatCols(zi, V3.zeros((n,), device), V3.zeros((n,), device),
                       z, z, V3.zeros((n,), device), z, zi)


def _cols_where(mask: torch.Tensor, a: MatCols, b: MatCols) -> MatCols:
    return MatCols(*(vwhere(mask, x, y) if isinstance(x, V3)
                     else torch.where(mask, x, y) for x, y in zip(a, b)))


def _gather_cols(mats: sc.Materials, mat_id: torch.Tensor) -> MatCols:
    """Material columns by per-lane gathers."""
    idx = mat_id.to(torch.int64)
    g = lambda a: a[idx]
    g3 = lambda a: V3(a[:, 0][idx], a[:, 1][idx], a[:, 2][idx])
    return MatCols(mtype=g(mats.mtype), color=g3(mats.color),
                   color2=g3(mats.color2), param=g(mats.param),
                   param2=g(mats.param2), absorption=g3(mats.absorption),
                   scatter_dist=g(mats.scatter_dist), tex_id=g(mats.tex_id))


def _material_table(mats: sc.Materials, ids: torch.Tensor) -> torch.Tensor:
    """[len(ids), 14] material columns joined by id (the feature rows the
    sphere kernel fetches for its winner)."""
    idx = ids.to(torch.int64)
    cols = [mats.mtype.to(torch.float32)[idx],
            mats.color[:, 0][idx], mats.color[:, 1][idx],
            mats.color[:, 2][idx],
            mats.color2[:, 0][idx], mats.color2[:, 1][idx],
            mats.color2[:, 2][idx],
            mats.param[idx], mats.param2[idx],
            mats.absorption[:, 0][idx], mats.absorption[:, 1][idx],
            mats.absorption[:, 2][idx],
            mats.scatter_dist[idx], mats.tex_id.to(torch.float32)[idx]]
    return torch.stack(cols, dim=1)


def _cols_from_feats(f, off: int) -> MatCols:
    """Decode the 14 material columns out of kernel feature outputs."""
    return MatCols(
        mtype=f[off + 0].to(torch.int32),
        color=V3(f[off + 1], f[off + 2], f[off + 3]),
        color2=V3(f[off + 4], f[off + 5], f[off + 6]),
        param=f[off + 7], param2=f[off + 8],
        absorption=V3(f[off + 9], f[off + 10], f[off + 11]),
        scatter_dist=f[off + 12],
        tex_id=f[off + 13].to(torch.int32))


class SceneView(NamedTuple):
    """The scene's hot tensors in the layout the bounce loop reads,
    built once per render."""
    sph_c: Optional[V3]                # sphere centers, [S] components
    sph_r: Optional[torch.Tensor]      # [S]
    sph_feat: Optional[torch.Tensor]   # [S, 18] center, radius, 14 mat cols
    tri_v0: Optional[V3] = None        # [T] components
    tri_e1: Optional[V3] = None
    tri_e2: Optional[V3] = None
    tri_n: Optional[V3] = None         # face normals e1×e2
    tri_feat: Optional[torch.Tensor] = None  # [T, 26] e1, e2, tc, 14 mat cols
    atlas: Optional[torch.Tensor] = None     # [K*H*W, 3] texel rows
    # BVH tiers: the kernel's tables (cuda_bvh.HeapTables or
    # cuda_bvh4.Bvh4Tables) and the [n_mats, 14] material rows
    packet: Optional[tuple] = None
    mat_rows: Optional[torch.Tensor] = None


def make_view(scene: Scene, config: Optional[RenderConfig] = None
              ) -> SceneView:
    sph_c = sph_r = sph_feat = None
    if scene.has_spheres:
        sph_c = V3.from_array(scene.sphere_center)
        sph_r = scene.sphere_radius.contiguous()
        sph_feat = torch.cat(
            [scene.sphere_center, sph_r[:, None],
             _material_table(scene.materials, scene.sphere_mat)],
            dim=1).contiguous()
    tri_v0 = tri_e1 = tri_e2 = tri_n = tri_feat = None
    packet = mat_rows = None
    tier = mesh_tier(scene, config) if config is not None else "oracle"
    if tier in ("bvh4", "heap"):
        packet = (_cb4.bvh4_tables(scene.mesh.bvh4) if tier == "bvh4"
                  else _cb.heap_tables(scene.mesh))
        mats = scene.materials
        mat_rows = _material_table(
            mats, torch.arange(mats.count, device=mats.mtype.device))
    elif scene.has_mesh:
        m = scene.mesh
        if m.brute is not None and tier == "brute":
            # the live triangles without the heap's sentinel padding: the
            # brute-force kernel reads only these (384 of 640 slots on the
            # staircase). Triangle ids then index these arrays, which only
            # the kernel's own feature rows are read with. The oracle
            # (use_bvh=False) gathers by padded ids and keeps the heap.
            mv0, mv1, mv2, mtc, mmid = m.brute
        else:
            mv0, mv1, mv2, mtc, mmid = (m.v0, m.v1, m.v2, m.tex_coords,
                                        m.mesh_id)
        tri_v0 = V3.from_array(mv0)
        tri_e1 = V3.from_array(mv1) - tri_v0
        tri_e2 = V3.from_array(mv2) - tri_v0
        tri_n = tri_e1.cross(tri_e2)
        safe_mid = torch.clamp(mmid, 0, scene.materials.count - 1)
        finite = lambda a: torch.nan_to_num(a, nan=0.0, posinf=0.0,
                                            neginf=0.0)
        tri_feat = torch.cat(
            [finite(mv1 - mv0), finite(mv2 - mv0), mtc,
             _material_table(scene.materials, safe_mid)], dim=1).contiguous()
    atlas = None
    if scene.has_textures:
        # [K,H,W,3] -> [K*H*W, 3]: one row gather fetches a texel
        atlas = scene.tex_atlas.reshape(-1, 3)
    return SceneView(sph_c, sph_r, sph_feat, tri_v0, tri_e1, tri_e2, tri_n,
                     tri_feat, atlas, packet, mat_rows)


def check_traversal(view: SceneView) -> None:
    """Raise if a BVH4 kernel launch over the view's tables stopped a
    ray whose ref stack would have outgrown ``stack_cap``
    (``cuda_bvh4.check_stack``: one device sync); other tiers cannot
    overflow. The engines call it once a render, after their loop."""
    if isinstance(view.packet, _cb4.Bvh4Tables):
        _cb4.check_stack(view.packet)


class Intersection(NamedTuple):
    """SoA intersection + the hit material's columns."""
    obj: torch.Tensor     # [N] int32 OBJ_* id
    t: torch.Tensor       # [N]
    normal: V3            # flipped to face the ray
    cols: MatCols         # material of the hit surface
    tex_u: torch.Tensor   # [N] texture coordinates of a mesh hit
    tex_v: torch.Tensor


class Stats(NamedTuple):
    """The reference's ray-accounting counters (kernels.cu:48–66) as
    masked sums, 0-dim int64 tensors on the render's device. Field names
    are the JAX package's. The traversal counters come from the BVH
    kernels and count per ray, summed over rays (the JAX package's packet
    kernels count per 1024-ray packet, so the two are not comparable):
    ``nodes_both``/``nodes_single``, interior steps that enter two / one
    child (heap) or find two or more / one hit child (BVH4);
    ``leaf_visits``, leaf visits; ``leaf_pop``, the BVH4 visits entered by
    popping a leaf ref (0 on the heap). The brute-force and oracle paths
    visit no nodes and leave them 0."""
    primary: torch.Tensor
    primary_hit_mesh: torch.Tensor
    primary_nohit: torch.Tensor
    primary_bbox_nohit: torch.Tensor
    secondary: torch.Tensor
    secondary_mesh: torch.Tensor
    secondary_nohit: torch.Tensor
    secondary_mesh_nohit: torch.Tensor
    secondary_bbox_nohit: torch.Tensor
    shadows: torch.Tensor
    shadows_bbox_nohit: torch.Tensor
    shadows_nohit: torch.Tensor
    low_power: torch.Tensor
    exceed_max_bounce: torch.Tensor
    roulette_kill: torch.Tensor
    nans: torch.Tensor
    nodes_both: torch.Tensor
    nodes_single: torch.Tensor
    leaf_visits: torch.Tensor
    leaf_pop: torch.Tensor

    @staticmethod
    def zeros(device) -> "Stats":
        z = torch.zeros((), dtype=torch.int64, device=device)
        return Stats(*([z] * len(Stats._fields)))

    def add(self, other: "Stats") -> "Stats":
        return Stats(*(a + b for a, b in zip(self, other)))

    def to_ints(self) -> "Stats":
        return Stats(*(int(a) for a in self))


# ---------------------------------------------------------------------------
# intersection
# ---------------------------------------------------------------------------


def _sphere_hit_one(origin: V3, direction: V3, center, radius,
                    t_min, t_max) -> torch.Tensor:
    """Single-sphere test (the light, kernels.cu:346)."""
    oc = origin - V3(center[0], center[1], center[2])
    b = oc.dot(direction)
    c = oc.dot(oc) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    ok = disc > 0.0
    t1v = torch.where(ok & (t1 > t_min) & (t1 < t_max), t1, FLT_MAX)
    t2v = torch.where(ok & (t2 > t_min) & (t2 < t_max), t2, FLT_MAX)
    return torch.minimum(t1v, t2v)


def _plane_hit(scene: Scene, origin: V3, direction: V3, t_min,
               t_max) -> torch.Tensor:
    """Single-sided plane (intersections.h:43–52)."""
    nrm = scene.plane_norm
    pt = scene.plane_point
    denom = (direction.x * nrm[0] + direction.y * nrm[1]
             + direction.z * nrm[2])
    po_dot_n = ((pt[0] - origin.x) * nrm[0] + (pt[1] - origin.y) * nrm[1]
                + (pt[2] - origin.z) * nrm[2])
    t = po_dot_n / denom
    miss = (denom > -1e-6) | (t < t_min) | (t > t_max)
    return torch.where(miss, FLT_MAX, t)


def _mesh_nearest(scene: Scene, origin: V3, direction: V3, t_min: float,
                  t_max) -> _bvh.TraceResult:
    """The all-triangles oracle of ``use_bvh=False`` (kernels.cu:307–321)
    over the mesh's padded arrays."""
    return _bvh.brute_force(scene.mesh, origin.stack(), direction.stack(),
                            t_min, t_max)


def _mesh_bbox_hit(scene: Scene, origin: V3, direction: V3,
                   t_max) -> torch.Tensor:
    """Global mesh-bbox slab test (hit_bbox at hitMesh, kernels.cu:298),
    for the ``*_bbox_nohit`` counters only. The where-form keeps the C
    NaN-comparison semantics of 0·inf lanes."""
    bmin = scene.mesh.bounds_min
    bmax = scene.mesh.bounds_max
    n = origin.x.shape
    tmin_acc = torch.full(n, BBOX_T_MIN, device=origin.x.device)
    tmax_acc = torch.as_tensor(t_max, dtype=torch.float32,
                               device=origin.x.device).expand(n)
    for o, d, a in ((origin.x, direction.x, 0), (origin.y, direction.y, 1),
                    (origin.z, direction.z, 2)):
        inv = 1.0 / d
        t0 = (bmin[a] - o) * inv
        t1 = (bmax[a] - o) * inv
        neg = inv < 0.0
        lo = torch.where(neg, t1, t0)
        hi = torch.where(neg, t0, t1)
        tmin_acc = torch.where(lo > tmin_acc, lo, tmin_acc)
        tmax_acc = torch.where(hi < tmax_acc, hi, tmax_acc)
    return tmax_acc >= tmin_acc


def _packet_nearest(view: SceneView, origin: V3, direction: V3,
                    t_min: float, t_max: torch.Tensor):
    """Large-mesh nearest hit through the BVH kernels, then the winner's
    features. Returns ((t, tri, u, v, normal V3, tu, tv, mid), per-ray
    counters [5, N])."""
    if isinstance(view.packet, _cb4.Bvh4Tables):
        t, tri, cnt = _cb4.bvh4_trace(origin, direction, t_max, view.packet,
                                      t_min)
    else:
        t, tri, cnt = _cb.heap_trace(origin, direction, t_max, view.packet,
                                     t_min)
    t, tri, u, v, nx, ny, nz, tu, tv, mid = _cb.winner_features(
        origin, direction, t, tri, view.packet.tri_feat)
    return (t, tri, u, v, V3(nx, ny, nz), tu, tv, mid), cnt


def _packet_shadow(view: SceneView, origin: V3, direction: V3,
                   t_min: float, t_max: torch.Tensor):
    """Large-mesh any-hit occlusion through the BVH kernels. Returns
    (occ [N], counters)."""
    if isinstance(view.packet, _cb4.Bvh4Tables):
        return _cb4.bvh4_occluded(origin, direction, t_max, view.packet,
                                  t_min)
    return _cb.heap_occluded(origin, direction, t_max, view.packet, t_min)


def _cols_from_rows(rows: torch.Tensor) -> MatCols:
    """Decode [N, 14] material-column rows (one row gather from the
    [n_mats, 14] table)."""
    return MatCols(
        mtype=rows[:, 0].to(torch.int32),
        color=V3(rows[:, 1], rows[:, 2], rows[:, 3]),
        color2=V3(rows[:, 4], rows[:, 5], rows[:, 6]),
        param=rows[:, 7], param2=rows[:, 8],
        absorption=V3(rows[:, 9], rows[:, 10], rows[:, 11]),
        scatter_dist=rows[:, 12],
        tex_id=rows[:, 13].to(torch.int32))


def intersect_scene(scene: Scene, view: SceneView, config: RenderConfig,
                    origin: V3, direction: V3, specular: torch.Tensor,
                    alive: Optional[torch.Tensor] = None):
    """Top-level ``hit()`` (kernels.cu:325–360) over a ray batch.

    Surfaces (spheres, plane, mesh) compete by nearest t; the analytic
    surfaces go first and their best t bounds the mesh test. The light
    sphere is tested only for specular lanes and only when no surface was
    hit (kernels.cu:339–349). Lanes with ``alive`` False trace the mesh
    with t_max = -1, which no triangle can beat.

    Returns (Intersection, per-ray traversal counters [5, N] of the BVH
    tiers, or None)."""
    n = origin.x.shape[0]
    dev = origin.x.device
    eps = config.epsilon
    t = torch.full((n,), FLT_MAX, device=dev)
    obj = torch.full((n,), sc.OBJ_NONE, dtype=torch.int32, device=dev)
    normal = V3.zeros((n,), dev)
    cols = MatCols.zeros(n, dev)
    tex_u = torch.zeros((n,), device=dev)
    tex_v = torch.zeros((n,), device=dev)
    if scene.has_spheres:
        st, _, f = _cs.spheres_hit_feat(origin, direction, view.sph_c,
                                        view.sph_r, view.sph_feat, eps,
                                        FLT_MAX)
        center = V3(f[0], f[1], f[2])
        radius = f[3]
        scols = _cols_from_feats(f, 4)
        win = st < t
        p = origin + direction * st
        nrm = (p - center) * (1.0 / torch.clamp_min(radius, 1e-30))
        t = torch.where(win, st, t)
        obj = torch.where(win, sc.OBJ_SPHERE, obj)
        normal = vwhere(win, nrm, normal)
        cols = _cols_where(win, scols, cols)

    if scene.has_plane:
        pt = _plane_hit(scene, origin, direction, eps, FLT_MAX)
        win = pt < t
        nrm = scene.plane_norm
        t = torch.where(win, pt, t)
        obj = torch.where(win, sc.OBJ_PLANE, obj)
        normal = vwhere(win, V3(nrm[0], nrm[1], nrm[2]), normal)
        pcols = _gather_cols(scene.materials, scene.plane_mat.expand(n))
        cols = _cols_where(win, pcols, cols)

    counters = None
    if scene.has_mesh:
        t_ray_max = t if alive is None else torch.where(alive, t, -1.0)
        if view.packet is not None:
            (tt, tri_id, u, vv, nrm_raw, tu, tv,
             mid), counters = _packet_nearest(view, origin, direction, eps,
                                               t_ray_max)
            hit = tri_id >= 0
            mid_c = torch.clamp(mid, 0, scene.materials.count - 1)
            mcols = _cols_from_rows(view.mat_rows[mid_c.to(torch.int64)])
            # miss lanes gather row 0: guard the normalize
            z = torch.zeros_like(tt)
            nrm = vwhere(hit, nrm_raw, V3(z, z, z + 1.0))
            nrm = nrm.normalized()  # kernels.cu:336
        elif config.use_bvh:
            tt, tri_id, u, vv, f = _ct.tris_hit_feat(
                origin, direction, view.tri_v0, view.tri_e1, view.tri_e2,
                view.tri_n, view.tri_feat, eps, t_ray_max)
            hit = tri_id >= 0
            e1 = V3(f[0], f[1], f[2])
            e2 = V3(f[3], f[4], f[5])
            w0 = 1.0 - u - vv
            # barycentric texcoord interpolation, kernels.cu:337–338
            tu = u * f[8] + vv * f[10] + w0 * f[6]
            tv = u * f[9] + vv * f[11] + w0 * f[7]
            mcols = _cols_from_feats(f, 12)
            nrm = e1.cross(e2).normalized()  # kernels.cu:336
        else:
            res = _mesh_nearest(scene, origin, direction, eps, t_ray_max)
            tt = res.t
            hit = res.tri_id >= 0
            tri = torch.clamp_min(res.tri_id, 0).to(torch.int64)
            e1 = V3(*(c[tri] for c in view.tri_e1))
            e2 = V3(*(c[tri] for c in view.tri_e2))
            tc = scene.mesh.tex_coords
            u, vv = res.u, res.v
            w0 = 1.0 - u - vv
            tu = u * tc[:, 2][tri] + vv * tc[:, 4][tri] + w0 * tc[:, 0][tri]
            tv = u * tc[:, 3][tri] + vv * tc[:, 5][tri] + w0 * tc[:, 1][tri]
            mcols = _gather_cols(
                scene.materials, torch.clamp(scene.mesh.mesh_id[tri], 0,
                                             scene.materials.count - 1))
            nrm = e1.cross(e2).normalized()  # kernels.cu:336
        win = hit & (tt < t)
        t = torch.where(win, tt, t)
        obj = torch.where(win, sc.OBJ_TRIMESH, obj)
        normal = vwhere(win, nrm, normal)
        cols = _cols_where(win, mcols, cols)
        tex_u = torch.where(win, tu, tex_u)
        tex_v = torch.where(win, tv, tex_v)

    if scene.use_nee:
        # light sphere only for specular rays with no surface hit
        # (kernels.cu:346–349)
        lt = _sphere_hit_one(origin, direction, scene.light_center,
                             scene.light_radius, eps, FLT_MAX)
        win = specular & (obj == sc.OBJ_NONE) & (lt < FLT_MAX)
        t = torch.where(win, lt, t)
        obj = torch.where(win, sc.OBJ_LIGHT, obj)

    # flip the normal to face the ray (kernels.cu:354–355)
    flip = direction.dot(normal) > 0.0
    normal = vwhere(flip, -normal, normal)
    return Intersection(obj=obj, t=t, normal=normal, cols=cols,
                        tex_u=tex_u, tex_v=tex_v), counters


def occluded(scene: Scene, view: SceneView, config: RenderConfig,
             origin: V3, direction: V3, t_max: torch.Tensor):
    """Shadow-ray occlusion (any-hit) against the mesh (kernels.cu:340)
    and, in analytic scenes, the spheres. Returns ([N] bool, per-ray
    traversal counters [5, N] of the BVH tiers or None)."""
    occ = torch.zeros(origin.x.shape, dtype=torch.bool,
                      device=origin.x.device)
    counters = None
    if scene.has_mesh:
        if view.packet is not None:
            mesh_occ, counters = _packet_shadow(view, origin, direction,
                                                config.epsilon, t_max)
            occ = occ | mesh_occ
        elif config.use_bvh:
            occ = occ | _ct.tris_anyhit_soa(
                origin, direction, view.tri_v0, view.tri_e1, view.tri_e2,
                view.tri_n, config.epsilon, t_max)
        else:
            res = _mesh_nearest(scene, origin, direction, config.epsilon,
                                t_max)
            occ = occ | (res.tri_id >= 0)
    if scene.has_spheres:
        occ = occ | _cs.spheres_anyhit_soa(origin, direction, view.sph_c,
                                           view.sph_r, config.epsilon, t_max)
    return occ, counters


def sky_radiance(scene: Scene, direction: V3) -> V3:
    """kernels.cu:424 (constant) / kernels.cu:419–421 (RTiOW gradient)."""
    if scene.sky_mode == sc.SKY_GRADIENT:
        t = 0.5 * (direction.y + 1.0)
        return V3(1.0 - 0.5 * t, 1.0 - 0.3 * t, torch.ones_like(t))
    c = scene.sky_color
    n = direction.x.shape[0]
    return V3(c[0].expand(n), c[1].expand(n), c[2].expand(n))


def resolve_albedo(scene: Scene, view: SceneView, config: RenderConfig,
                   cols: MatCols, tex_u: torch.Tensor, tex_v: torch.Tensor,
                   use_tex: torch.Tensor) -> V3:
    """Texture-or-color albedo (kernels.cu:456–476): nearest-neighbor
    wrap-mode lookup as one row gather from the flat texel table."""
    base = cols.color
    if not (scene.has_textures and config.textures):
        return base
    tid = cols.tex_id
    k, hmax, wmax = scene.tex_atlas.shape[:3]
    tid_c = torch.clamp(tid, 0, k - 1).to(torch.int64)
    w = scene.tex_width[tid_c]
    h = scene.tex_height[tid_c]
    fu = tex_u - torch.floor(tex_u)
    fv = tex_v - torch.floor(tex_v)
    # float -> int32 truncates toward zero, as the JAX astype does
    tx = ((w - 1).to(torch.float32) * fu).to(torch.int32)
    ty = ((h - 1).to(torch.float32) * fv).to(torch.int32)
    flat = (tid_c * hmax + ty) * wmax + tx
    # out-of-range rows clamp, as a JAX gather does
    texel_rows = view.atlas[torch.clamp(flat, 0, view.atlas.shape[0] - 1)]
    texel = V3(texel_rows[:, 0], texel_rows[:, 1], texel_rows[:, 2])
    return vwhere(use_tex & (tid >= 0), texel, base)


def generate_shadow_rays(scene: Scene, origin: V3, normal: V3,
                         attenuation: V3, eps1: torch.Tensor,
                         eps2: torch.Tensor):
    """Solid-angle sphere-light sampling (generateShadowRay,
    kernels.cu:363–393). Returns (valid, shadow_dir, contribution,
    light_dist)."""
    lc = scene.light_center
    to_light = V3(lc[0] - origin.x, lc[1] - origin.y, lc[2] - origin.z)
    sw = to_light.normalized()
    big_x = torch.abs(sw.x) > 0.01
    up = V3(torch.where(big_x, 0.0, 1.0), torch.where(big_x, 1.0, 0.0),
            torch.zeros_like(sw.x))
    su = up.cross(sw).normalized()
    sv = sw.cross(su)

    d2 = to_light.squared_length()
    ratio = 1.0 - scene.light_radius * scene.light_radius / d2
    valid = ratio >= 0.0  # isnan(cosAMax) guard, kernels.cu:372
    cos_a_max = torch.sqrt(torch.clamp_min(ratio, 0.0))
    cos_a = 1.0 - eps1 + eps1 * cos_a_max
    sin_a = torch.sqrt(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
    phi = 2.0 * math.pi * eps2
    l = (su * (torch.cos(phi) * sin_a) + sv * (torch.sin(phi) * sin_a)
         + sw * cos_a)
    dotl = l.dot(normal)
    valid = valid & (dotl > 0.0)
    shadow_dir = l.normalized()
    omega = 2.0 * math.pi * (1.0 - cos_a_max)
    scale = dotl * omega / math.pi
    lcol = scene.light_color
    contribution = attenuation * V3(lcol[0] * scale, lcol[1] * scale,
                                    lcol[2] * scale)
    light_dist = torch.sqrt(d2) - scene.light_radius  # kernels.cu:390
    return valid, shadow_dir, contribution, light_dist


# ---------------------------------------------------------------------------
# one bounce
# ---------------------------------------------------------------------------


class BounceState(NamedTuple):
    """Per-lane path state threaded through one bounce."""
    origin: V3
    direction: V3
    color: V3
    attenuation: V3
    specular: torch.Tensor
    inside: torch.Tensor
    alive: torch.Tensor
    # previous bounce hit the triangle mesh (STATS ``fromMesh``) — only
    # the stats counters read it
    from_mesh: torch.Tensor


def bounce_step(scene: Scene, view: SceneView, config: RenderConfig,
                state: BounceState, pixel: torch.Tensor, sample,
                bounce, stats: Optional[Stats] = None
                ) -> Tuple[BounceState, Optional[Stats]]:
    """One wavefront bounce for all lanes — the body of ``color()``
    (kernels.cu:402–527). ``sample`` and ``bounce`` are ints (plain
    engine) or per-lane [N] tensors (regeneration engine)."""
    dev = pixel.device
    base = _rng.bounce_base(pixel, sample, bounce)
    bounce = torch.as_tensor(bounce, device=dev)
    alive = state.alive
    zeros = lambda: V3.zeros(alive.shape, dev)

    def count(stat, mask):
        return stat + mask.sum()

    def add_counters(stats, cnt):
        if cnt is None:
            return stats
        tot = cnt[:4].sum(dim=1, dtype=torch.int64)
        return stats._replace(
            nodes_both=stats.nodes_both + tot[0],
            nodes_single=stats.nodes_single + tot[1],
            leaf_visits=stats.leaf_visits + tot[2],
            leaf_pop=stats.leaf_pop + tot[3])

    inters, cnt = intersect_scene(scene, view, config, state.origin,
                                  state.direction, state.specular,
                                  alive=alive)
    if stats is not None:
        stats = add_counters(stats, cnt)
        # per-bounce counters, kernels.cu:404-407
        primary_m = alive & (bounce == 0)
        secondary_m = alive & (bounce > 0)
        low = alive & (state.attenuation.squared_length() < 1e-4)
        stats = stats._replace(
            primary=count(stats.primary, primary_m),
            secondary=count(stats.secondary, secondary_m),
            secondary_mesh=count(stats.secondary_mesh,
                                 alive & state.from_mesh),
            low_power=count(stats.low_power, low))
        if scene.has_mesh:
            # global mesh-bbox reject accounting (hitMesh,
            # kernels.cu:298-300)
            bbhit = _mesh_bbox_hit(scene, state.origin, state.direction,
                                   FLT_MAX)
            stats = stats._replace(
                primary_bbox_nohit=count(stats.primary_bbox_nohit,
                                         primary_m & ~bbhit),
                secondary_bbox_nohit=count(stats.secondary_bbox_nohit,
                                           secondary_m & ~bbhit))

    # ---- miss → sky (kernels.cu:424)
    miss = alive & (inters.obj == sc.OBJ_NONE)
    color = state.color + vwhere(
        miss, state.attenuation * sky_radiance(scene, state.direction),
        zeros())
    is_mesh_hit = inters.obj == sc.OBJ_TRIMESH
    if stats is not None:
        hit_any = alive & ~miss
        stats = stats._replace(
            # the quirk at kernels.cu:430: a primary ray hitting a
            # non-mesh surface also counts as primary_nohit
            primary_nohit=count(
                stats.primary_nohit,
                (bounce == 0) & (miss | (hit_any & ~is_mesh_hit))),
            primary_hit_mesh=count(stats.primary_hit_mesh,
                                   (bounce == 0) & hit_any & is_mesh_hit),
            secondary_nohit=count(stats.secondary_nohit,
                                  miss & (bounce > 0) & ~state.from_mesh),
            secondary_mesh_nohit=count(
                stats.secondary_mesh_nohit,
                miss & (bounce > 0) & state.from_mesh))

    # ---- light hit by a specular path (kernels.cu:433–447)
    light_hit = alive & (inters.obj == sc.OBJ_LIGHT)
    if not config.shadow:
        lc = scene.light_color
        color = color + vwhere(
            light_hit, state.attenuation * V3(lc[0], lc[1], lc[2]), zeros())

    surf = alive & ~miss & ~light_hit
    alive = surf

    # ---- scatter (kernels.cu:452–489)
    cols = inters.cols
    albedo = resolve_albedo(scene, view, config, cols, inters.tex_u,
                            inters.tex_v, is_mesh_hit)
    hit_p = state.origin + state.direction * inters.t
    out = _m.scatter(
        wo=state.direction, normal=inters.normal, hit_t=inters.t,
        hit_p=hit_p, inside=state.inside,
        mtype=cols.mtype, albedo=albedo, color2=cols.color2,
        param=cols.param, param2=cols.param2, absorption=cols.absorption,
        scatter_dist=cols.scatter_dist, rng_base=base)

    new_origin = vwhere(surf, state.origin + state.direction * out.t,
                        state.origin)
    # non-unit SSS directions are normalized at store time (the JAX
    # package's choice; the reference re-normalizes in the ray ctor)
    new_dir = vwhere(surf, out.wi.normalized(), state.direction)
    new_att = vwhere(surf, state.attenuation * out.throughput,
                     state.attenuation)
    new_specular = torch.where(surf, out.specular, state.specular)
    new_inside = torch.where(surf, state.inside ^ out.refracted,
                             state.inside)

    # ---- NEE shadow pass (kernels.cu:491–510)
    if config.shadow and scene.use_nee:
        nee_mask = surf & ~new_specular
        valid, sdir, contrib, ldist = generate_shadow_rays(
            scene, new_origin, inters.normal, new_att,
            _rng.slot_uniform(base, _rng.S_NEE0),
            _rng.slot_uniform(base, _rng.S_NEE1))
        nee_mask = nee_mask & valid
        # lanes without a shadow ray get t_max = -1: no occluder can hit
        occ, cnt = occluded(scene, view, config, new_origin, sdir,
                            torch.where(nee_mask, ldist, -1.0))
        lit = nee_mask & ~occ
        color = color + vwhere(lit, contrib, zeros())
        if stats is not None:
            stats = add_counters(stats, cnt)
            stats = stats._replace(
                shadows=count(stats.shadows, nee_mask),
                shadows_nohit=count(stats.shadows_nohit, lit))
            if scene.has_mesh:
                sbb = _mesh_bbox_hit(scene, new_origin, sdir, ldist)
                stats = stats._replace(
                    shadows_bbox_nohit=count(stats.shadows_bbox_nohit,
                                             nee_mask & ~sbb))

    # ---- Russian roulette (kernels.cu:512–527)
    if config.russian_roulette:
        rr = alive & (bounce > config.rr_start_bounce)
        mx = new_att.max3()
        kill = rr & (_rng.slot_uniform(base, _rng.S_ROULETTE) > mx)
        alive = alive & ~kill
        scale = torch.where(rr & ~kill, 1.0 / torch.clamp_min(mx, 1e-30),
                            1.0)
        new_att = new_att * scale
        if stats is not None:
            stats = stats._replace(roulette_kill=count(stats.roulette_kill,
                                                       kill))

    # fromMesh for the next bounce (kernels.cu:430)
    new_from_mesh = surf & is_mesh_hit
    return BounceState(origin=new_origin, direction=new_dir, color=color,
                       attenuation=new_att, specular=new_specular,
                       inside=new_inside, alive=alive,
                       from_mesh=new_from_mesh), stats


def initial_state(origin: V3, direction: V3,
                  alive: torch.Tensor) -> BounceState:
    """Fresh paths: black, unit attenuation, outside, not specular."""
    dev = alive.device
    f = torch.zeros_like(alive)
    return BounceState(
        origin=origin, direction=direction,
        color=V3.zeros(alive.shape, dev),
        attenuation=V3.ones(alive.shape, dev),
        specular=f, inside=f, alive=alive, from_mesh=f)


def trace(scene: Scene, camera: Camera, config: RenderConfig,
          pixel_id: torch.Tensor, sample: int,
          valid: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, Stats]:
    """Trace one sample for each pixel lane; returns ([N,3] radiance,
    Stats). This is ``color()`` (kernels.cu:396–533) as a wavefront loop
    that runs until every lane is dead or ``max_depth`` bounces.

    ``valid`` (optional [N] bool) marks real lanes; tail-padding
    duplicate lanes start dead so they never inflate the Stats."""
    check_supported(scene, config)
    dev = pixel_id.device
    view = make_view(scene, config)
    origin, direction = camera.generate_rays(pixel_id, sample,
                                             config.nx, config.ny)
    alive = (torch.ones(pixel_id.shape, dtype=torch.bool, device=dev)
             if valid is None else valid.clone())
    state = initial_state(origin, direction, alive)
    stats = Stats.zeros(dev)
    bounce = 0
    # one host sync per bounce: the loop ends when every lane is dead
    while bounce < config.max_depth and bool(state.alive.any()):
        state, new_stats = bounce_step(scene, view, config, state,
                                       pixel_id, sample, bounce,
                                       stats if config.stats else None)
        if new_stats is not None:
            stats = new_stats
        bounce += 1
    check_traversal(view)
    if config.stats:
        stats = stats._replace(
            exceed_max_bounce=stats.exceed_max_bounce + state.alive.sum())
    if config.check_nans:
        isnan = (torch.isnan(state.color.x) | torch.isnan(state.color.y)
                 | torch.isnan(state.color.z))
        stats = stats._replace(nans=stats.nans + isnan.sum())
    return state.color.stack(), stats
