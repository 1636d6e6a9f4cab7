"""Host-side SAH BVH4 tables (counterpart of ``tpu_pathtracer/ops/bvh4.py``).

The heap BVH (``ops/bvh.py``) is the reference's implicit complete binary
tree, whose equal-count splits suit smooth parametric meshes and hurt
irregular ones (terrain, architectural interiors). This module builds the
JAX package's alternative, in NumPy at scene construction, with the same
arithmetic and the same tier decisions, so a mesh gets the same tables
and the same triangle order (which decides exact ties) in both packages:

  * a binned-SAH binary tree over the mesh's finite triangles, under the
    packet cost model (a leaf visit costs its full cluster ``width``, so
    splits count ceil(n / width) visits): the native C++ builder when it
    compiles, the NumPy one otherwise;
  * collapsed into a 4-wide tree whose children are binary grandchildren
    (slots 0, 1 = left pair, 2, 3 = right pair);
  * a per-mesh tier: f32 node tables, uint16-quantized ones, or none (the
    mesh stays on the heap), chosen by ``attach_bvh4``.

Ref encoding of the ``refs`` table: 0 = empty slot, +k = interior node
k−1, −(c+1) = leaf cluster c. Cluster c holds SAH slots
[c·width, (c+1)·width); ``tri_map`` gives each slot's heap slot (−1 =
padding).

The byte budgets below are the TPU's scalar-memory (SMEM) sizes that the
JAX package's kernels copy the node table into. They mean nothing on a
GPU, where the per-ray kernel reads the table from global memory; they
are kept, with their values, because they choose the tier, and so which
kernel a mesh takes and which triangle order it gets.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from tpu_pathtracer_torch.models.scene import MeshData

# the kernels' triangle rows (v0, e1, e2, n = e1×e2) as columns of the
# 19-wide feature rows (n, tc0..5, mid, v0, e1, e2)
TRI_COLUMNS = (10, 11, 12, 13, 14, 15, 16, 17, 18, 0, 1, 2)

# measured packet cost model of the JAX package's TPU kernels
A_NS = 300.0     # per node step
TRI_NS = 18.4    # per triangle slot of a leaf visit

# TPU SMEM budgets: the f32 tier's table, and the quantized tier's
SMEM_TABLE_BUDGET = 400 << 10
# a tree landing in the quant tier is attached only if its expected cost
# ratio against the heap walk is at most this ("auto" selection)
QUANT_AUTO_RATIO = 0.85
QUANT_TABLE_BUDGET = 640 << 10


@dataclasses.dataclass(frozen=True)
class Bvh4Data:
    """SAH BVH4 tables of one mesh, as tensors on the mesh's device.

    ``bounds``, ``refs``, ``qparams``, ``tri_feat`` and ``tri_map`` equal
    the JAX package's element for element. The kernels read the port's
    own triangle table ``tri``, made from ``tri_feat`` (the JAX package's
    TPU DMA blocks are not carried)."""
    bounds: torch.Tensor   # [n_nodes*24] f32: node n child k at 24n+6k
    # (minx,miny,minz,maxx,maxy,maxz), empty slots inverted; or, quantized,
    # [n_nodes*12] int32 words of uint16 bounds (see _quantize4)
    refs: torch.Tensor     # [n_nodes*4] int32
    tri_feat: torch.Tensor  # [C*width, 19] f32 winner features: n, tc0..5,
    # mid, v0, e1, e2
    tri_map: torch.Tensor  # [C*width] int32 heap slot per SAH slot, -1 pad
    n_nodes: int
    width: int
    stack_cap: int         # 3·depth + 8 >= the deepest ref stack of a walk
    quant: bool = False
    qparams: object = None  # [8] f32 sx,sy,sz,lox,loy,loz,0,0 (quant tier)

    @property
    def n_clusters(self) -> int:
        return self.tri_map.shape[0] // self.width

    @property
    def tri(self) -> torch.Tensor:
        """[C*width, 12] f32 rows v0, e1, e2, n = e1×e2 in SAH slot order;
        padding rows are zero (a = 0: they miss)."""
        return self.tri_feat[:, TRI_COLUMNS].contiguous()


def _area3(mn, mx):
    d = np.maximum(mx - mn, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
        + d[..., 2] * d[..., 0]


def _build_sah_binary(v0, v1, v2, width, n_bins=16, ct=1.0):
    """Binned-SAH binary tree under the per-visit cost model (NumPy).

    Returns (bmin [Nb,3], bmax [Nb,3], c0 [Nb], c1 [Nb], order [T],
    leaf_first [Nb], leaf_count [Nb], depth): interior nodes have c0/c1 =
    child indices; leaves have c0 = -1 and leaf_first/leaf_count into
    ``order`` (the SAH triangle permutation)."""
    ci = TRI_NS * width / A_NS  # node steps per leaf visit
    T = v0.shape[0]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    cent = 0.5 * (tmin + tmax)

    bmin_l, bmax_l, c0_l, c1_l, lf_l, lc_l = [], [], [], [], [], []
    order = []
    n_ordered = 0

    def new_node():
        for lst in (bmin_l, bmax_l):
            lst.append(None)
        for lst in (c0_l, c1_l, lf_l, lc_l):
            lst.append(0)
        return len(c0_l) - 1

    root = new_node()
    stack = [(root, np.arange(T, dtype=np.int64), 0)]
    max_depth = 0
    while stack:
        node, idxs, depth = stack.pop()
        max_depth = max(max_depth, depth)
        bb_min = tmin[idxs].min(0)
        bb_max = tmax[idxs].max(0)
        bmin_l[node] = bb_min
        bmax_l[node] = bb_max
        nt = len(idxs)

        best = None  # (sah child sum, left mask)
        c = cent[idxs]
        for axis in range(3):
            lo, hi = c[:, axis].min(), c[:, axis].max()
            if hi - lo < 1e-12:
                continue
            bins = np.minimum(((c[:, axis] - lo) / (hi - lo)
                               * n_bins).astype(np.int64), n_bins - 1)
            cnt = np.bincount(bins, minlength=n_bins)
            bmn = np.full((n_bins, 3), 1e30, np.float64)
            bmx = np.full((n_bins, 3), -1e30, np.float64)
            np.minimum.at(bmn, bins, tmin[idxs])
            np.maximum.at(bmx, bins, tmax[idxs])
            lmn = np.minimum.accumulate(bmn, 0)
            lmx = np.maximum.accumulate(bmx, 0)
            rmn = np.minimum.accumulate(bmn[::-1], 0)[::-1]
            rmx = np.maximum.accumulate(bmx[::-1], 0)[::-1]
            lc = np.cumsum(cnt)[:-1]
            rc = nt - lc
            vl = -(-lc // width)  # ceil: the fewest leaf visits left
            vr = -(-rc // width)
            cost = _area3(lmn, lmx)[:-1] * vl \
                + _area3(rmn[1:], rmx[1:]) * vr
            valid = (lc > 0) & (rc > 0)
            if not valid.any():
                continue
            j = int(np.argmin(np.where(valid, cost, 1e30)))
            if best is None or cost[j] < best[0]:
                best = (cost[j], bins <= j)

        parent_area = max(_area3(bb_min, bb_max), 1e-30)
        if nt <= width and (
                best is None
                or ct + ci * best[0] / parent_area >= ci * 1.0):
            c0_l[node] = -1
            lf_l[node] = n_ordered
            lc_l[node] = nt
            order.append(idxs)
            n_ordered += nt
            continue
        if best is None:
            # degenerate centroids: forced median halves
            axis = int(np.argmax(bb_max - bb_min))
            srt = np.argsort(cent[idxs][:, axis], kind="stable")
            lmask = np.zeros(nt, bool)
            lmask[srt[: nt // 2]] = True
        else:
            lmask = best[1]
        l_id = new_node()
        r_id = new_node()
        c0_l[node] = l_id
        c1_l[node] = r_id
        stack.append((l_id, idxs[lmask], depth + 1))
        stack.append((r_id, idxs[~lmask], depth + 1))

    return (np.stack(bmin_l).astype(np.float32),
            np.stack(bmax_l).astype(np.float32),
            np.asarray(c0_l, np.int64), np.asarray(c1_l, np.int64),
            np.concatenate(order) if order else np.zeros(0, np.int64),
            np.asarray(lf_l, np.int64), np.asarray(lc_l, np.int64),
            max_depth)


def _collapse4(bmin, bmax, c0, c1, lf, lc):
    """Collapse the binary tree to 4-wide nodes: each BVH4 node's children
    are the binary node's grandchildren (a binary-leaf child stays a direct
    child in slot 0 of its pair). Returns (bounds [Nn*24] f32, refs [Nn*4]
    i32, clusters list of (first, count), depth4)."""
    INV = np.array([1e30, 1e30, 1e30, -1e30, -1e30, -1e30], np.float32)

    clusters = []  # (first, count) per BVH4 leaf cluster

    def leaf_ref(b):
        clusters.append((int(lf[b]), int(lc[b])))
        return -len(clusters)  # -(c+1)

    bounds_rows = []
    refs_rows = []
    if c0[0] < 0:
        # degenerate single-leaf tree: one node, one child slot
        bounds = np.tile(INV, 4).astype(np.float32)
        bounds[0:3] = bmin[0]
        bounds[3:6] = bmax[0]
        refs = np.zeros(4, np.int32)
        refs[0] = leaf_ref(0)
        return (bounds, refs, clusters, 1)

    # binary interior node -> BVH4 node id, breadth first
    node_of = {0: 0}
    queue = [0]
    depth_of = {0: 1}
    depth4 = 1
    next_id = 1
    order4 = []
    while queue:
        b = queue.pop(0)
        order4.append(b)
        slots = []
        for ch in (c0[b], c1[b]):
            if c0[ch] < 0:
                slots.append((ch, True))
                slots.append(None)
            else:
                for g in (c0[ch], c1[ch]):
                    slots.append((g, c0[g] < 0))
        for s in slots:
            if s is not None and not s[1]:
                g = s[0]
                node_of[g] = next_id
                depth_of[g] = depth_of[b] + 1
                depth4 = max(depth4, depth_of[g])
                next_id += 1
                queue.append(g)

    for b in order4:
        row_b = np.tile(INV, 4).astype(np.float32)
        row_r = np.zeros(4, np.int32)
        slots = []
        for ch in (c0[b], c1[b]):
            if c0[ch] < 0:
                slots.append(ch)
                slots.append(None)
            else:
                slots.append(c0[ch])
                slots.append(c1[ch])
        for k, g in enumerate(slots):
            if g is None:
                continue
            row_b[6 * k: 6 * k + 3] = bmin[g]
            row_b[6 * k + 3: 6 * k + 6] = bmax[g]
            if c0[g] < 0:
                row_r[k] = leaf_ref(g)
            else:
                row_r[k] = node_of[g] + 1
        bounds_rows.append(row_b)
        refs_rows.append(row_r)

    return (np.concatenate(bounds_rows), np.concatenate(refs_rows),
            clusters, depth4)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _sah_binary_for(mesh: MeshData, width: int, n_bins: int,
                    host: dict | None = None):
    """Take the mesh's finite triangles and build the binary SAH tree
    (native C++ builder when it compiles, NumPy otherwise). Returns
    (tris, built): tris = (v0, v1, v2, tc, mid, slot_ids), built = the
    ``_build_sah_binary`` tuple. ``host``: the mesh's arrays as numpy
    (``ops.bvh.build_bvh`` passes them), else they are read off the
    mesh's tensors."""
    get = (lambda k: np.asarray(host[k])) if host is not None else \
        (lambda k: _host(getattr(mesh, k)))
    v0a = get("v0")
    sane = np.isfinite(v0a).all(1)
    slot_ids = np.nonzero(sane)[0].astype(np.int64)
    v0 = v0a[sane]
    v1 = get("v1")[sane]
    v2 = get("v2")[sane]
    tc = get("tex_coords")[sane]
    mid = get("mesh_id")[sane]

    from tpu_pathtracer_torch.native import native_bvh4_binary
    built = native_bvh4_binary(v0, v1, v2, width, n_bins,
                               ci=TRI_NS * width / A_NS, ct=1.0)
    if built is None:
        built = _build_sah_binary(v0, v1, v2, width, n_bins)
    return (v0, v1, v2, tc, mid, slot_ids), built


def expected_cost_ratio(mesh: MeshData, bounds: np.ndarray,
                        refs: np.ndarray, width: int,
                        host: dict | None = None) -> float:
    """SA-heuristic expected traversal cost of a candidate BVH4 tree
    relative to the mesh's heap tree under the packet cost model (A_NS
    per two-level node step, TRI_NS per leaf slot); < 1 predicts the SAH
    topology cheaper. The JAX package's tier criterion, unchanged."""
    if host is not None:
        hmin = np.asarray(host["bvh_min"], np.float64)
        hmax = np.asarray(host["bvh_max"], np.float64)
    else:
        hmin = _host(mesh.bvh_min).astype(np.float64)
        hmax = _host(mesh.bvh_max).astype(np.float64)
    L = mesh.first_leaf
    sa = _area3(hmin, hmax)
    sa = np.where(np.isfinite(sa), sa, 0.0)  # sentinel-padded leaves
    root = max(float(sa[1]), 1e-30)
    heap = (0.5 * A_NS * float(sa[1:L].sum() / root)
            + mesh.prims_per_leaf * TRI_NS
            * float(sa[L: 2 * L].sum() / root))
    b = np.asarray(bounds, np.float64).reshape(-1, 4, 6)
    r = np.asarray(refs).reshape(-1, 4)
    csa = _area3(b[..., 0:3], b[..., 3:6])
    csa = np.where(r != 0, csa, 0.0)
    # every non-root node's box is one interior child slot; the root
    # contributes its own area
    quad = (A_NS * (1.0 + float(csa[r > 0].sum() / root))
            + width * TRI_NS * float(csa[r < 0].sum() / root))
    return quad / max(heap, 1e-30)


def build_bvh4(mesh: MeshData, width: int = 64, n_bins: int = 16,
               host: dict | None = None) -> Bvh4Data:
    """The f32 SAH BVH4 tables of ``mesh``, whatever their size. The mesh
    keeps its heap tree; the BVH4 carries its own triangle order."""
    tris, built = _sah_binary_for(mesh, width, n_bins, host=host)
    bmin, bmax, c0, c1, order, lf, lc, _ = built
    bounds, refs, clusters, depth4 = _collapse4(bmin, bmax, c0, c1, lf, lc)
    return _assemble4(tris, order, bounds, refs, clusters, depth4, width,
                      mesh.v0.device)


def _assemble4(tris, order, bounds, refs, clusters, depth4, width: int,
               device) -> Bvh4Data:
    """Lay the triangles out in cluster order: the [C*width, 19] feature
    rows and the slot map."""
    v0, v1, v2, tc, mid, slot_ids = tris
    C = len(clusters)
    S = C * width
    pv0 = np.zeros((S, 3), np.float32)
    pe1 = np.zeros((S, 3), np.float32)
    pe2 = np.zeros((S, 3), np.float32)
    ptc = np.zeros((S, 6), np.float32)
    pmid = np.zeros(S, np.float32)
    tri_map = np.full(S, -1, np.int32)
    for c, (first, count) in enumerate(clusters):
        sl = slice(c * width, c * width + count)
        tids = order[first: first + count]
        pv0[sl] = v0[tids]
        pe1[sl] = v1[tids] - v0[tids]
        pe2[sl] = v2[tids] - v0[tids]
        ptc[sl] = tc[tids]
        pmid[sl] = mid[tids]
        tri_map[sl] = slot_ids[tids]
    nrm = np.cross(pe1, pe2)  # zero rows for padding -> a = 0 -> miss
    tri_feat = np.concatenate([nrm, ptc, pmid[:, None], pv0, pe1, pe2],
                              axis=1).astype(np.float32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return Bvh4Data(bounds=t(bounds), refs=t(refs),
                    tri_feat=t(tri_feat), tri_map=t(tri_map),
                    n_nodes=int(refs.shape[0] // 4), width=int(width),
                    stack_cap=int(3 * depth4 + 8))


def _quantize4(bounds: np.ndarray, refs: np.ndarray):
    """Pack the [Nn*24] f32 child bounds into [Nn*12] int32 words of
    uint16 bounds relative to the root box, rounded outward plus one
    quantum, so every dequantized box contains the true box; empty slots
    (ref 0) get inverted boxes (qlo = 65535, qhi = 0). Words:
    w0 = qminx | qminy<<16, w1 = qminz | qmaxx<<16, w2 = qmaxy | qmaxz<<16;
    dq(q) = f32(q) * s_axis + lo_axis. Returns (words, qparams [8] f32)."""
    b = bounds.reshape(-1, 4, 6).astype(np.float64)
    live = refs.reshape(-1, 4) != 0
    mins = b[..., 0:3]
    maxs = b[..., 3:6]
    root_lo = np.where(live[..., None], mins, 1e30).min(axis=(0, 1))
    root_hi = np.where(live[..., None], maxs, -1e30).max(axis=(0, 1))
    # offset rounded down so dq(0) <= lo
    lo32 = np.nextafter(root_lo.astype(np.float32),
                        np.float32(-np.inf)).astype(np.float64)
    s32 = (np.maximum(root_hi - root_lo, 1e-20) / 65000.0) \
        .astype(np.float32).astype(np.float64)
    qlo = np.clip(np.floor((mins - lo32) / s32) - 1, 0, 65535)
    qhi = np.clip(np.ceil((maxs - lo32) / s32) + 1, 0, 65535)
    qlo = np.where(live[..., None], qlo, 65535).astype(np.uint32)
    qhi = np.where(live[..., None], qhi, 0).astype(np.uint32)
    w0 = qlo[..., 0] | (qlo[..., 1] << 16)
    w1 = qlo[..., 2] | (qhi[..., 0] << 16)
    w2 = qhi[..., 1] | (qhi[..., 2] << 16)
    words = np.stack([w0, w1, w2], axis=-1).reshape(-1) \
        .astype(np.uint32).view(np.int32)
    qparams = np.concatenate([s32, lo32, np.zeros(2)]).astype(np.float32)
    return words, qparams


def attach_bvh4(mesh: MeshData, width: int = 64, n_bins: int = 16,
                silent: bool = False, quant: str | bool = "auto",
                auto_ratio: float | None = None,
                host: dict | None = None) -> MeshData:
    """``mesh`` with SAH BVH4 tables attached, by the JAX package's tiers.

    Tables within ``SMEM_TABLE_BUDGET`` stay f32. Bigger ones take the
    uint16 quantized tier when they fit ``QUANT_TABLE_BUDGET`` (``quant``
    True forces it, False disables it); with ``auto_ratio`` set, a
    quant-tier tree is attached only if ``expected_cost_ratio`` is at
    most ``auto_ratio``. A mesh that fits no tier comes back unchanged
    (with a warning unless ``silent``) and stays on the heap kernels."""
    tris, built = _sah_binary_for(mesh, width, n_bins, host=host)
    bmin, bmax, c0, c1, order, lf, lc, _ = built
    bounds, refs, clusters, depth4 = _collapse4(bmin, bmax, c0, c1, lf, lc)
    n_nodes = refs.shape[0] // 4
    table_bytes = (bounds.size + refs.size) * 4
    qtable_bytes = (n_nodes * 12 + refs.size) * 4
    use_quant = quant is True or (quant == "auto"
                                  and table_bytes > SMEM_TABLE_BUDGET
                                  and qtable_bytes <= QUANT_TABLE_BUDGET)
    if use_quant and quant == "auto" and auto_ratio is not None:
        ratio = expected_cost_ratio(mesh, bounds, refs, width, host=host)
        if ratio > auto_ratio:
            if not silent:
                warnings.warn(
                    f"BVH4 quant tier skipped: expected cost ratio "
                    f"{ratio:.2f} > {auto_ratio:.2f}; the mesh stays on "
                    "the heap BVH.", RuntimeWarning, stacklevel=2)
            return mesh
    if not use_quant and table_bytes > SMEM_TABLE_BUDGET:
        if not silent:
            warnings.warn(
                f"BVH4 node table ({table_bytes >> 10} KB for {n_nodes} "
                f"nodes; {qtable_bytes >> 10} KB quantized) exceeds the "
                f"table budgets ({SMEM_TABLE_BUDGET >> 10}/"
                f"{QUANT_TABLE_BUDGET >> 10} KB); the mesh stays on the "
                "heap BVH.", RuntimeWarning, stacklevel=2)
        return mesh
    data = _assemble4(tris, order, bounds, refs, clusters, depth4, width,
                      mesh.v0.device)
    if use_quant:
        words, qp = _quantize4(bounds, refs)
        dev = mesh.v0.device
        data = dataclasses.replace(
            data, bounds=torch.as_tensor(words, device=dev), quant=True,
            qparams=torch.as_tensor(qp, device=dev))
    return dataclasses.replace(mesh, bvh4=data)
