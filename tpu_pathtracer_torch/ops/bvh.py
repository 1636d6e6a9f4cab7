"""BVH: host-side construction, ``BVH_00.04`` serialization and the
no-BVH all-triangles oracle (counterpart of ``tpu_pathtracer/ops/bvh.py``).

  * :func:`build_bvh` — the implicit complete binary heap the kernels
    assume: nodes indexed from 1, ``first_leaf = num_nodes // 2``
    (kernels.cu:614), leaf ``i`` covering ``prims_per_leaf`` consecutive
    reordered triangles with sentinel padding (kernels.cu:199–203). Built
    in numpy exactly as the JAX package builds it, so the triangle order
    (which decides exact ties) is the same.
  * :func:`load_bvh_file` / :func:`save_bvh_file` — bit-compatible
    ``BVH_00.04`` serialization.
  * :func:`brute_force` — the all-triangles scan ``use_bvh=False`` takes.
  * :func:`traverse` — the dual-node bitstack traversal of the reference's
    ``hitBvh`` (kernels.cu:148–224), one ray at a time: the plain version
    of the heap kernel ``csrc/bvh.cu`` (``ops/cuda_bvh.py``).

Meshes the JAX package gives SAH BVH4 tables get them here too
(``ops/bvh4.py``).
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from tpu_pathtracer_torch.models.scene import MeshData
from tpu_pathtracer_torch.ops import bvh4 as _b4
from tpu_pathtracer_torch.ops import cuda_bvh as _cb
from tpu_pathtracer_torch.ops.cuda_spheres import _tmax_vector
from tpu_pathtracer_torch.ops.intersect import triangles_hit
from tpu_pathtracer_torch.ops.v3 import V3

# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              tex_coords: np.ndarray | None = None,
              mesh_id: np.ndarray | None = None,
              prims_per_leaf: int = 5,
              builder: str = "auto",
              bvh4: str | bool = "auto",
              device="cuda") -> MeshData:
    """Build an implicit-heap BVH over triangles (host-side, NumPy) and
    return it as tensors on ``device``.

    ``builder``: "auto" takes the native binned-SAH order when the C++
    builder compiles (``tpu_pathtracer_torch.native``) and the NumPy
    median split otherwise; "sah" / "median" force one.

    ``bvh4``: "auto" attaches SAH BVH4 tables (``ops.bvh4.attach_bvh4``)
    to meshes of more than 8192 triangles whose node table plausibly fits
    one of the JAX package's tiers, with its quant-tier cost gate; True
    forces the attach, False skips it. The tables feed the BVH4 kernels
    (``ops/cuda_bvh4.py``); a mesh without them takes the heap kernels.

    Median split: largest centroid-extent axis; the complete tree is
    packed left-first so every leaf except a right-edge tail is full.
    Triangle arrays are reordered and padded to ``num_leaves *
    prims_per_leaf`` with +inf sentinel triangles (kernels.cu:202).
    """
    native_build_order = None
    if builder in ("auto", "sah"):
        from tpu_pathtracer_torch import native
        if native.load() is not None:
            native_build_order = native.native_build_order
        elif builder == "sah":
            raise RuntimeError("builder='sah' but the native builder "
                               "is unavailable")

    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]
    if tex_coords is None:
        tex_coords = np.zeros((T, 6), np.float32)
    if mesh_id is None:
        mesh_id = np.zeros((T,), np.int32)
    tex_coords = np.asarray(tex_coords, np.float32)
    mesh_id = np.asarray(mesh_id, np.int32)

    P = prims_per_leaf
    num_leaves = max(_next_pow2((T + P - 1) // P), 2)

    centroids = (v0 + v1 + v2) / 3.0
    # slots[k] = original triangle index at padded slot k, -1 for padding
    slots = np.full(num_leaves * P, -1, np.int64)
    order = None
    if native_build_order is not None:
        tri_min = np.minimum(np.minimum(v0, v1), v2)
        tri_max = np.maximum(np.maximum(v0, v1), v2)
        order = native_build_order(tri_min, tri_max, num_leaves, P)
    if order is None:
        order = _median_order(centroids, num_leaves, P)
    slots[:] = order  # both builders return the padded slot layout

    def take(arr, fill):
        out = np.full((num_leaves * P,) + arr.shape[1:], fill, arr.dtype)
        mask = slots >= 0
        out[mask] = arr[slots[mask]]
        return out

    rv0 = take(v0, np.inf)
    rv1 = take(v1, np.inf)
    rv2 = take(v2, np.inf)
    rtc = take(tex_coords, 0.0)
    rmid = take(mesh_id, 0)

    bvh_min, bvh_max = _node_boxes(rv0, rv1, rv2, num_leaves, P)
    t = lambda a: torch.as_tensor(a, device=device)
    brute = None
    if num_leaves * P <= 16384 and (slots >= 0).sum() < num_leaves * P:
        # the live triangles in slot order, for the brute-force kernel
        live = slots >= 0
        brute = (t(rv0[live]), t(rv1[live]), t(rv2[live]), t(rtc[live]),
                 t(rmid[live]))
    mesh = MeshData(
        v0=t(rv0), v1=t(rv1), v2=t(rv2), tex_coords=t(rtc),
        mesh_id=t(rmid), bvh_min=t(bvh_min), bvh_max=t(bvh_max),
        bounds_min=t(bvh_min[1]), bounds_max=t(bvh_max[1]),
        first_leaf=num_leaves, prims_per_leaf=P, brute=brute)
    if bvh4 is True or (bvh4 == "auto" and _bvh4_auto_eligible(T)):
        # the host arrays, so the attach reads nothing back from the card
        host = dict(v0=rv0, v1=rv1, v2=rv2, tex_coords=rtc, mesh_id=rmid,
                    bvh_min=bvh_min, bvh_max=bvh_max)
        mesh = _b4.attach_bvh4(
            mesh, silent=(bvh4 == "auto"),
            auto_ratio=_b4.QUANT_AUTO_RATIO if bvh4 == "auto" else None,
            host=host)
    return mesh


def _bvh4_auto_eligible(n_tris: int, width: int = 64) -> bool:
    """The JAX package's rule for attaching BVH4 tables by default:
    meshes above the packet threshold (8192 triangles) whose node table
    plausibly fits one of its tiers (the estimate assumes one cluster a
    node, about twice the measured count; ``attach_bvh4`` decides)."""
    est_nodes = -(-n_tris // width)
    return n_tris > 8192 and (112 * est_nodes <= 2 * _b4.SMEM_TABLE_BUDGET
                              or 64 * est_nodes
                              <= 2 * _b4.QUANT_TABLE_BUDGET)


def _median_order(centroids: np.ndarray, num_leaves: int,
                  P: int) -> np.ndarray:
    """Recursive median partition producing the padded slot order.

    Returns an int64 array of length num_leaves*P with original triangle
    indices, -1 marking empty slots. Left-packed: each internal split
    gives the left subtree ``min(len, capacity/2)`` triangles after
    sorting along the widest centroid axis.
    """
    out = np.full(num_leaves * P, -1, np.int64)
    stack = [(np.arange(centroids.shape[0], dtype=np.int64), 0, num_leaves)]
    while stack:
        idxs, leaf0, nl = stack.pop()
        if len(idxs) == 0:
            continue
        if nl == 1:
            out[leaf0 * P: leaf0 * P + len(idxs)] = idxs
            continue
        c = centroids[idxs]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        srt = idxs[np.argsort(c[:, axis], kind="stable")]
        half_cap = (nl // 2) * P
        take_left = min(len(srt), max((len(srt) + 1) // 2,
                                      len(srt) - half_cap))
        take_left = min(take_left, half_cap)
        stack.append((srt[:take_left], leaf0, nl // 2))
        stack.append((srt[take_left:], leaf0 + nl // 2, nl // 2))
    return out


def _node_boxes(v0, v1, v2, num_leaves: int, P: int):
    """Bottom-up box computation for the complete tree. Empty leaves get
    inverted boxes (min=+big, max=-big) that can never be hit."""
    num_nodes = 2 * num_leaves
    bvh_min = np.full((num_nodes, 3), 1e30, np.float32)
    bvh_max = np.full((num_nodes, 3), -1e30, np.float32)

    tri_min = np.minimum(np.minimum(v0, v1), v2).reshape(num_leaves, P, 3)
    tri_max = np.maximum(np.maximum(v0, v1), v2).reshape(num_leaves, P, 3)
    finite = np.isfinite(tri_min).all(-1) & np.isfinite(tri_max).all(-1)
    tri_min = np.where(finite[..., None], tri_min, 1e30)
    tri_max = np.where(finite[..., None], tri_max, -1e30)
    bvh_min[num_leaves:] = tri_min.min(axis=1)
    bvh_max[num_leaves:] = tri_max.max(axis=1)
    for i in range(num_leaves - 1, 0, -1):
        bvh_min[i] = np.minimum(bvh_min[2 * i], bvh_min[2 * i + 1])
        bvh_max[i] = np.maximum(bvh_max[2 * i], bvh_max[2 * i + 1])
    return bvh_min, bvh_max


# ---------------------------------------------------------------------------
# BVH_00.04 serialization (staircase_scene.h:75–101)
# ---------------------------------------------------------------------------

BVH_HEADER = b"BVH_00.04\x00"

# MSVC layout of `triangle` (helper_structs.h:81–96): 9 f32 verts + 6 f32
# texcoords + u8 meshID + 3 pad = 64 bytes.
_TRI_DTYPE = np.dtype([
    ("v", np.float32, (3, 3)),
    ("tc", np.float32, (6,)),
    ("mesh", np.uint8),
    ("pad", np.uint8, (3,)),
])
assert _TRI_DTYPE.itemsize == 64


def load_bvh_file(path: str, device="cuda") -> MeshData:
    """Read a reference-format ``.bvh`` scene binary into MeshData on
    ``device``. The triangles keep the file's heap order with sentinel
    padding, and no compacted ``brute`` copy is made."""
    with open(path, "rb") as f:
        header = f.read(len(BVH_HEADER))
        if header != BVH_HEADER:
            raise ValueError(f"invalid header {header!r}")
        (num_tris,) = struct.unpack("<i", f.read(4))
        tris = np.frombuffer(f.read(num_tris * _TRI_DTYPE.itemsize),
                             dtype=_TRI_DTYPE)
        (num_nodes,) = struct.unpack("<i", f.read(4))
        nodes = np.frombuffer(f.read(num_nodes * 24),
                              dtype=np.float32).reshape(num_nodes, 6)
        bounds = np.frombuffer(f.read(24), dtype=np.float32)
        (ppl,) = struct.unpack("<i", f.read(4))

    first_leaf = num_nodes // 2  # kernels.cu:614
    # the reference's traversal bitstack is uint32: one bit per level
    # below the root (kernels.cu:157)
    depth = max(first_leaf, 1).bit_length()
    if depth > 32:
        raise ValueError(
            f"BVH depth {depth} exceeds the 32-level uint32 bitstack")
    # pad triangle arrays out to full leaf coverage with sentinels
    want = first_leaf * ppl
    v = tris["v"].astype(np.float32)
    tc = tris["tc"].astype(np.float32)
    mid = tris["mesh"].astype(np.int32)
    if want > num_tris:
        pad = want - num_tris
        v = np.concatenate([v, np.full((pad, 3, 3), np.inf, np.float32)])
        tc = np.concatenate([tc, np.zeros((pad, 6), np.float32)])
        mid = np.concatenate([mid, np.zeros((pad,), np.int32)])
    t = lambda a: torch.as_tensor(np.array(a), device=device)  # writable
    return MeshData(
        v0=t(v[:, 0]), v1=t(v[:, 1]), v2=t(v[:, 2]),
        tex_coords=t(tc), mesh_id=t(mid),
        bvh_min=t(nodes[:, 0:3]), bvh_max=t(nodes[:, 3:6]),
        bounds_min=t(bounds[0:3]), bounds_max=t(bounds[3:6]),
        first_leaf=first_leaf, prims_per_leaf=ppl)


def save_bvh_file(path: str, mesh: MeshData) -> None:
    """Write MeshData as a reference-format ``.bvh`` binary."""
    T = mesh.num_tris
    host = lambda a: a.detach().cpu().numpy()
    mid = host(mesh.mesh_id)
    mid_max = int(mid.max(initial=0))
    if mid_max > 255:
        raise ValueError(
            f"mesh_id {mid_max} > 255 cannot round-trip through the "
            "reference's uint8 triangle meshID field (helper_structs.h:81)")
    tris = np.zeros(T, dtype=_TRI_DTYPE)
    tris["v"][:, 0] = host(mesh.v0)
    tris["v"][:, 1] = host(mesh.v1)
    tris["v"][:, 2] = host(mesh.v2)
    tris["tc"] = host(mesh.tex_coords)
    tris["mesh"] = mid.astype(np.uint8)
    nodes = np.concatenate([host(mesh.bvh_min), host(mesh.bvh_max)],
                           axis=1).astype(np.float32)
    with open(path, "wb") as f:
        f.write(BVH_HEADER)
        f.write(struct.pack("<i", T))
        f.write(tris.tobytes())
        f.write(struct.pack("<i", nodes.shape[0]))
        f.write(nodes.tobytes())
        f.write(host(mesh.bounds_min).astype(np.float32).tobytes())
        f.write(host(mesh.bounds_max).astype(np.float32).tobytes())
        f.write(struct.pack("<i", mesh.prims_per_leaf))


# ---------------------------------------------------------------------------
# The all-triangles oracle
# ---------------------------------------------------------------------------


class TraceResult(NamedTuple):
    t: torch.Tensor       # [N] closest hit (== t_max when missed)
    tri_id: torch.Tensor  # [N] int32, -1 = miss
    u: torch.Tensor       # [N] barycentric u
    v: torch.Tensor       # [N] barycentric v
    # traversal steps into both / a single child (kernels.cu:220-221),
    # summed over rays; 0 on the brute-force path, which visits no nodes
    nodes_both: int = 0
    nodes_single: int = 0


def traverse(mesh: MeshData, origin: torch.Tensor, direction: torch.Tensor,
             t_min, t_max, is_shadow: bool = False) -> TraceResult:
    """The reference's dual-node bitstack traversal (kernels.cu:154–224)
    of every ray (``origin``/``direction`` [N, 3]): the plain version of
    the heap kernel (``ops.cuda_bvh``), with u and v recomputed for the
    winner. With ``is_shadow`` a ray stops at its first hit: ``tri_id`` is
    that hit's slot (>= 0 exactly on occluded rays) and ``t`` stays
    ``t_max``."""
    tabs = _cb.heap_tables(mesh)
    o, d = V3.from_array(origin), V3.from_array(direction)
    tmax = _tmax_vector(t_max, origin.shape[0], o.x)
    t, tri, _, cnt = _cb._heap_walk_ref(o, d, tmax, tabs, float(t_min),
                                        any_hit=is_shadow)
    _, _, u, v, *_ = _cb.winner_features(o, d, t, tri, tabs.tri_feat)
    return TraceResult(t=t, tri_id=tri, u=u, v=v,
                       nodes_both=int(cnt[0].sum(dtype=torch.int64)),
                       nodes_single=int(cnt[1].sum(dtype=torch.int64)))


BRUTE_CHUNK = 2048  # triangles per pass (bounds the [N, chunk] temporaries)


def brute_force(mesh: MeshData, origin: torch.Tensor,
                direction: torch.Tensor, t_min, t_max) -> TraceResult:
    """No-BVH all-triangles scan (kernels.cu:307–321) — the slow oracle
    ``use_bvh=False`` takes. ``origin``/``direction`` are ``[N, 3]``;
    triangle ids index the mesh's (padded) arrays.

    Scans triangle chunks with a running min; the first minimum of a
    chunk wins it, and a chunk's winner replaces the running one only
    when strictly closer, so the first of tied triangles wins.
    """
    n = origin.shape[0]
    dev = origin.device
    closest = torch.as_tensor(t_max, dtype=torch.float32,
                              device=dev).expand(n).clone()
    tri_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    uu = torch.zeros((n,), device=dev)
    vv = torch.zeros((n,), device=dev)
    rows = torch.arange(n, device=dev)
    for base in range(0, mesh.num_tris, BRUTE_CHUNK):
        sl = slice(base, base + BRUTE_CHUNK)
        tt, tu, tv = triangles_hit(
            mesh.v0[sl][None], mesh.v1[sl][None], mesh.v2[sl][None],
            origin[:, None, :], direction[:, None, :], t_min,
            closest[:, None])
        tbest, j = torch.min(tt, dim=1)  # first index of the minimum
        won = tbest < closest
        closest = torch.where(won, tbest, closest)
        tri_id = torch.where(won, (j + base).to(torch.int32), tri_id)
        uu = torch.where(won, tu[rows, j], uu)
        vv = torch.where(won, tv[rows, j], vv)
    return TraceResult(t=closest, tri_id=tri_id, u=uu, v=vv)
