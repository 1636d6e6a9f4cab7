"""Nearest / any ray-triangle hit over the heap BVH by a packet walk with
leaf queues: the CUDA kernel ``csrc/bvh_mr.cu`` and its plain PyTorch
version (counterpart of ``experiments/pallas_bvh_mr.py``: ``_kernel_mr``
through ``packet_trace_mr`` and ``packet_occluded_mr``, the JAX package's
measured-negative multirow decision record; no config reaches it).

A packet is 32 consecutive rays (on the card the lanes of its warps:
one walks, all test its leaf rounds) that share one walk over the
implicit heap: one node index, one uint32 bitstack and a queue of up to
``QUEUE`` leaves. In a node round every lane slab-tests both
children of the packet's node against its own closest t; the packet
enters a child if some lane does, the nearer first by the lanes' vote
(right if more lanes that enter both find it strictly nearer than find
it not), as ``_kernel_mr``'s node round (``pallas_bvh_mr.py:257-291``).
A packet at a leaf pushes it onto its queue and pops on
(``push_leaves`` :243-255). A leaf round tests every lane against every
queued leaf's triangles, in queue order then slot order, with
``pt::mt_hit`` and a strict <. It fires when the queue is full or the
packet cannot step (``fire_and_active`` :362-374 read for one packet:
its third clause, that every active row has work queued, holds for one
row whenever its queue is not empty, and would make the queue one deep).
Any-hit: a lane that hits retires (closest = −1e30), and a packet whose
lanes have all retired stops after its leaf round (:335, :357-358).

Contract: per ray, exactly the heap walk's nearest hit (``cuda_bvh``, K5)
and occlusion (K6). The cull against a closest t that lags behind the
queued leaves only enlarges the visit set. t equals K5's; winners differ
from K5's only where two triangles give the same t (C-3). Lanes past the
last ray are padding (t_max 0, inert; −1 on the any-hit path, retired at
once), as the JAX wrapper pads (:445, :502). Lanes with t_max <= 0 test
nothing.

Counters count per 32-ray packet, not per ray: int32 [3, P] for
P = ceil(N / 32) packets, rows nodes_both and nodes_single (node rounds
entering two / one child) and leaf_visits (queued leaves tested). They
are neither the per-ray counters of the other heap kernels nor the JAX
kernel's, which count per 128-ray row; never compare them with either.

The public functions dispatch on the device of their inputs: tensors on
the CPU go to the plain version, tensors on a CUDA device to the kernel
(or the call raises). There is no fallback from one to the other. Kernel
and plain version agree bit for bit: t, winners, occlusion and counters.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as _cb
from tpu_pathtracer_torch.ops.cuda_spheres import _on_cuda, _tmax_vector
from tpu_pathtracer_torch.ops.v3 import V3

# Kernel launches by the wrappers below, per mode. Callers reset them to
# 0 and read them back to show that a run went through the kernel.
LAUNCHES = {"nearest": 0, "any_hit": 0}

COUNTERS = ("nodes_both", "nodes_single", "leaf_visits")
LANES = 32   # rays a packet: a warp's lanes
QUEUE = 4    # queued leaves a packet (pallas_bvh_mr.py:56); csrc kQueue
RETIRED = -1e30  # closest of an any-hit lane after its hit
_NEAREST, _ANY_HIT = 0, 1  # csrc/bvh_mr.cu Mode
_MODE_NAMES = {_NEAREST: "nearest", _ANY_HIT: "any_hit"}
_LEAF_PACKETS = 512  # packets a plain leaf test handles at once


# ---------------------------------------------------------------------------
# plain PyTorch version: every packet a round per pass
# ---------------------------------------------------------------------------


def _pop(bs: torch.Tensor, idx: torch.Tensor):
    m = _cb._ctz32(bs)
    return (bs >> m) ^ 1, (idx >> m) ^ 1


def _node_round(o, inv, neg, closest, idx, bs, cnt, tabs, pk,
                visits: Optional[dict]):
    """One node step of the packets ``pk`` (all at an interior node): the
    lanes' slab tests of both children and the vote."""
    l2 = idx[pk] * 2
    pair = torch.stack([l2, l2 + 1], dim=1)
    if visits is not None:
        visits["nodes"].append(pair.flatten())
    box = tabs.nodes[pair][:, None]  # [M, 1, 2, 8]
    c = closest[pk]                  # [M, 32]
    h = _cb.slab_entry(box[..., 0:3], box[..., 3:6], o[pk][:, :, None],
                       inv[pk][:, :, None], neg[pk][:, :, None],
                       c[:, :, None].expand(-1, -1, 2))
    lh, rh = h[..., 0], h[..., 1]
    tl, tr = lh < c, rh < c
    pref = torch.where(tl & tr, torch.where(rh < lh, 1, -1), 0).sum(1)
    vl, vr = tl.any(1), tr.any(1)
    both, single = vl & vr, vl ^ vr
    cnt[0, pk] += both.to(torch.int64)
    cnt[1, pk] += single.to(torch.int64)
    b, i = bs[pk], idx[pk]
    pb, pi = _pop(b, i)
    child = torch.where(both, l2 + (pref > 0).to(torch.int64),
                        torch.where(vl, l2, l2 + 1))
    idx[pk] = torch.where(both | single, child, pi)
    bs[pk] = torch.where(both, (b << 1) + 1,
                         torch.where(single, b << 1, pb))


def _leaf_round(o, d, closest, best, occ, qids, qcnt, idx, cnt, tabs,
                t_min, any_hit, pk, visits: Optional[dict]):
    """The leaf round of the packets ``pk``: every lane against every
    queued leaf, in queue order, each leaf's slots in order."""
    P = tabs.prims_per_leaf
    slots = torch.arange(P, device=o.device)
    for q in range(QUEUE):
        pq = pk[qcnt[pk] > q]
        if pq.numel() == 0:
            break
        cnt[2, pq] += 1
        if visits is not None:
            visits["leaves"].append(qids[pq, q])
        for s in range(0, pq.numel(), _LEAF_PACKETS):
            p = pq[s:s + _LEAF_PACKETS]
            base = qids[p, q] * P
            m = p.numel()
            rows = tabs.tri[base[:, None] + slots]  # [m, P, 12]
            rows = rows[:, None].expand(-1, LANES, -1, -1).reshape(
                m * LANES, P, 12)
            hit, new_c, j, _ = _cb.leaf_step(
                rows, o[p].reshape(-1, 3), d[p].reshape(-1, 3), t_min,
                closest[p].reshape(-1))
            hit = hit.view(m, LANES)
            if any_hit:
                occ[p] |= hit
                closest[p] = torch.where(hit, RETIRED, closest[p])
            else:
                closest[p] = new_c.view(m, LANES)
                best[p] = torch.where(hit, base[:, None] + j.view(m, LANES),
                                      best[p])
    qcnt[pk] = 0
    if any_hit:
        dead = (closest[pk] < 0.0).all(dim=1)
        idx[pk[dead]] = 0


def _mr_walk_ref(origin: V3, direction: V3, tmax: torch.Tensor,
                 tabs: _cb.HeapTables, t_min: float, any_hit: bool,
                 visits: Optional[dict] = None):
    """(closest [N], tri [N] int32, occ [N] bool, counters [3, P] int32):
    the kernel's packet walk, every packet one round per pass. ``visits``,
    if given, gathers the ids of the node rows (``visits["nodes"]``) and
    leaves (``visits["leaves"]``) the walk reads, a tensor of each a
    round; the node rows number twice the node rounds."""
    n = origin.x.shape[0]
    dev = tmax.device
    n_pk = (n + LANES - 1) // LANES
    pad = n_pk * LANES - n

    def lanes(a, fill):
        return torch.cat([a, a.new_full((pad,), fill)]).view(n_pk, LANES)

    o = torch.stack([lanes(c, 0.0) for c in origin], dim=2)
    d = torch.stack([lanes(c, f) for c, f in zip(direction,
                                                 (1.0, 0.0, 0.0))], dim=2)
    inv = 1.0 / d
    neg = inv < 0.0
    closest = lanes(tmax, -1.0 if any_hit else 0.0)
    best = torch.full((n_pk, LANES), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros((n_pk, LANES), dtype=torch.bool, device=dev)
    idx = torch.ones((n_pk,), dtype=torch.int64, device=dev)
    bs = torch.ones_like(idx)
    qids = torch.zeros((n_pk, QUEUE), dtype=torch.int64, device=dev)
    qcnt = torch.zeros_like(idx)
    cnt = torch.zeros((3, n_pk), dtype=torch.int64, device=dev)
    fl = tabs.first_leaf
    while True:
        active = (idx > 0) | (qcnt > 0)
        fire = (qcnt > 0) & ((qcnt >= QUEUE) | (idx == 0))
        walk = (active & ~fire).nonzero().flatten()
        leaf = fire.nonzero().flatten()
        if walk.numel() == 0 and leaf.numel() == 0:
            break
        if leaf.numel():
            _leaf_round(o, d, closest, best, occ, qids, qcnt, idx, cnt, tabs,
                        t_min, any_hit, leaf, visits)
        if walk.numel():
            # a packet at a leaf with room queues it and pops on
            push = walk[(idx[walk] >= fl) & (qcnt[walk] < QUEUE)]
            qids[push, qcnt[push]] = idx[push] - fl
            qcnt[push] += 1
            bs[push], idx[push] = _pop(bs[push], idx[push])
            inner = walk[(idx[walk] > 0) & (idx[walk] < fl)]
            if inner.numel():
                _node_round(o, inv, neg, closest, idx, bs, cnt, tabs, inner,
                            visits)
    return (closest.flatten()[:n], best.flatten()[:n].to(torch.int32),
            occ.flatten()[:n], cnt.to(torch.int32))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("bvh_mr")
    fn = lib.bvh_mr_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i] + [p] * 9 + [i, i, ctypes.c_float, i]
                       + [p] * 5)
        fn.restype = ctypes.c_int
    return lib


def _launch(mode: int, origin: V3, direction: V3, tmax: torch.Tensor,
            tabs: _cb.HeapTables, t_min: float):
    """Check the inputs, allocate the outputs and launch one mode of the
    kernel on the current stream."""
    if tabs.tri.shape[1:] != (12,):
        raise ValueError("triangle rows must be [T, 12]")
    dev, n = _cb.check_walk_inputs(origin, direction, tmax, tabs, tabs.tri,
                                   "triangle")
    n_pk = (n + LANES - 1) // LANES
    cnt = torch.empty((3, n_pk), dtype=torch.int32, device=dev)
    t_out = tri_out = occ_out = None
    if mode == _ANY_HIT:
        occ_out = torch.empty((n,), dtype=torch.bool, device=dev)
    else:
        t_out = torch.empty((n,), dtype=torch.float32, device=dev)
        tri_out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        ptr = lambda a: None if a is None else a.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().bvh_mr_launch(
                mode, *(a.data_ptr() for a in (*origin, *direction, tmax)),
                tabs.nodes.data_ptr(), tabs.tri.data_ptr(), tabs.first_leaf,
                tabs.prims_per_leaf, float(t_min), n, ptr(t_out),
                ptr(tri_out), ptr(occ_out), cnt.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"packet-walk BVH kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES[_MODE_NAMES[mode]] += 1
    return t_out, tri_out, occ_out, cnt


# ---------------------------------------------------------------------------
# public entry points (the JAX package's packet_trace_mr /
# packet_occluded_mr, over the port's heap tables)
# ---------------------------------------------------------------------------


def _mr_trace_ref(origin: V3, direction: V3, t_max, tabs: _cb.HeapTables,
                  t_min: float):
    tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
    t, tri, _, cnt = _mr_walk_ref(origin, direction, tmax, tabs, t_min,
                                  False)
    return _cb.winner_features(origin, direction, t, tri, tabs.tri_feat), cnt


def _mr_occluded_ref(origin: V3, direction: V3, t_max,
                     tabs: _cb.HeapTables, t_min: float):
    tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
    _, _, occ, cnt = _mr_walk_ref(origin, direction, tmax, tabs, t_min, True)
    return occ, cnt


def mr_trace(origin: V3, direction: V3, t_max, tabs: _cb.HeapTables,
             t_min: float) -> Tuple[tuple, torch.Tensor]:
    """Nearest hit: ((t, tri, u, v, nx, ny, nz, tu, tv, mid), counters),
    the outputs of ``packet_trace_mr``: t is the ray's t_max on a miss, tri
    the heap slot (-1 on a miss), the rest ``cuda_bvh.winner_features``;
    counters int32 [3, P] per 32-ray packet (module docstring)."""
    if _on_cuda(origin):
        tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
        t, tri, _, cnt = _launch(_NEAREST, origin, direction, tmax, tabs,
                                 t_min)
        return (_cb.winner_features(origin, direction, t, tri,
                                    tabs.tri_feat), cnt)
    return _mr_trace_ref(origin, direction, t_max, tabs, t_min)


def mr_occluded(origin: V3, direction: V3, t_max, tabs: _cb.HeapTables,
                t_min: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any hit in (t_min, t_max): (occ [N] bool, counters [3, P] int32).
    Lanes with t_max <= 0 test nothing."""
    if _on_cuda(origin):
        tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
        _, _, occ, cnt = _launch(_ANY_HIT, origin, direction, tmax, tabs,
                                 t_min)
        return occ, cnt
    return _mr_occluded_ref(origin, direction, t_max, tabs, t_min)
