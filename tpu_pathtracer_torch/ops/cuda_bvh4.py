"""Nearest / any ray-triangle hit over the SAH BVH4 tables: the CUDA
kernel ``csrc/bvh4.cu`` and its plain PyTorch version (counterpart of
``tpu_pathtracer/ops/pallas_bvh4.py``: ``_kernel_nearest4`` through
``packet_trace4`` and ``_kernel_shadow4`` through ``packet_occluded4``).

The public functions dispatch on the device of their inputs: tensors on
the CPU go to the plain version, tensors on a CUDA device to the kernel
(or the call raises). There is no fallback from one to the other.

Both walk each ray with its own ref stack, nearest hit child first, in
the same order step for step (the contract is in ``csrc/bvh4.cu``), so t,
the winning SAH slot, occlusion and the per-ray counters agree bit for
bit between them. Winner ids are SAH cluster slots; ``tri_map`` maps them
to heap slots. The winner's features come from
``ops.cuda_bvh.winner_features`` over ``Bvh4Data.tri_feat``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops.bvh4 import Bvh4Data
from tpu_pathtracer_torch.ops.cuda_bvh import leaf_step, slab_entry
from tpu_pathtracer_torch.ops.cuda_spheres import _check, _on_cuda, \
    _tmax_vector
from tpu_pathtracer_torch.ops.v3 import V3

# Kernel launches by the wrappers below, per mode. Callers reset them to
# 0 and read them back to show that a run went through the kernel.
LAUNCHES = {"nearest": 0, "any_hit": 0}

STACK_CAPACITY = 128  # csrc/bvh4.cu kStackCap
_NEAREST, _ANY_HIT = 0, 1  # csrc/bvh4.cu Mode
_MODE_NAMES = {_NEAREST: "nearest", _ANY_HIT: "any_hit"}


class Bvh4Tables(NamedTuple):
    """The BVH4 tables of a mesh in the layout the kernel reads."""
    bounds: torch.Tensor    # [n_nodes*24] f32 (quantized tables dequantized)
    refs: torch.Tensor      # [n_nodes*4] int32
    tri: torch.Tensor       # [C*width, 12] f32
    tri_feat: torch.Tensor  # [C*width, 19] f32
    width: int
    stack_cap: int
    overflow: torch.Tensor  # [1] int32: the kernel sets it to 1 when a
    # ray's stack would outgrow stack_cap (check_stack raises for it)


def dequantize(words: torch.Tensor, qparams: torch.Tensor) -> torch.Tensor:
    """[n*12] int32 words of uint16 bounds -> [n*24] f32 bounds with the
    JAX kernels' arithmetic (``pallas_bvh._node_bounds4``): q as f32 times
    the axis scale plus the axis offset. The boxes were rounded outward
    when quantized, so they contain the true boxes."""
    w = words.to(torch.int64).reshape(-1, 3)
    q = torch.stack([w[:, 0] & 0xFFFF, (w[:, 0] >> 16) & 0xFFFF,
                     w[:, 1] & 0xFFFF, (w[:, 1] >> 16) & 0xFFFF,
                     w[:, 2] & 0xFFFF, (w[:, 2] >> 16) & 0xFFFF], dim=1)
    s = qparams[[0, 1, 2, 0, 1, 2]]
    lo = qparams[[3, 4, 5, 3, 4, 5]]
    return (q.to(torch.float32) * s + lo).reshape(-1).contiguous()


def bvh4_tables(b4: Bvh4Data) -> Bvh4Tables:
    """The kernel's view of ``b4``: f32 bounds (dequantized once for the
    quant tier) beside the tables as they are."""
    bounds = dequantize(b4.bounds, b4.qparams) if b4.quant else b4.bounds
    return Bvh4Tables(bounds.contiguous(), b4.refs.contiguous(), b4.tri,
                      b4.tri_feat.contiguous(), b4.width, b4.stack_cap,
                      torch.zeros((1,), dtype=torch.int32,
                                  device=b4.refs.device))


def check_stack(tabs: Bvh4Tables) -> None:
    """Raise if a kernel launch over ``tabs`` stopped a ray whose ref
    stack would have outgrown ``stack_cap`` (that ray's hit is then
    wrong). Reads the kernel's flag, so it waits for the launches before
    it on the card."""
    if bool(tabs.overflow[0]):
        raise RuntimeError(f"BVH4 ref stack overflow: a ray needed more "
                           f"than stack_cap = {tabs.stack_cap} entries")


# ---------------------------------------------------------------------------
# plain PyTorch version: the kernel's walk, all rays a step at a time
# ---------------------------------------------------------------------------


def _bvh4_walk_ref(origin: V3, direction: V3, tmax: torch.Tensor,
                   tabs: Bvh4Tables, t_min: float, any_hit: bool,
                   visits: Optional[dict] = None):
    """(closest [N], tri [N] int32, occ [N] bool, counters [5, N] int32):
    the kernel's walk with every ray advancing one step per pass; with
    ``any_hit``, tri is the slot whose hit ended the walk. Raises if a
    ray's stack would outgrow ``stack_cap``. ``visits``, if given, gathers
    the ids of the nodes (``visits["nodes"]``) and leaf clusters
    (``visits["leaves"]``) the walk reads, a tensor of each a pass."""
    o = origin.stack()
    d = direction.stack()
    inv = 1.0 / d
    neg = inv < 0.0
    n = o.shape[0]
    dev = o.device
    w, cap = tabs.width, tabs.stack_cap
    bounds = tabs.bounds.reshape(-1, 4, 6)
    refs = tabs.refs.reshape(-1, 4).to(torch.int64)
    closest = tmax.clone()
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    cnt = torch.zeros((5, n), dtype=torch.int64, device=dev)
    cur = torch.where(closest > 0.0, 1, 0).to(torch.int64)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    stack = torch.zeros((n, max(cap, 1)), dtype=torch.int64, device=dev)
    popped = torch.zeros((n,), dtype=torch.bool, device=dev)
    slots = torch.arange(w, device=dev)

    def pop(lanes):
        s = sp[lanes]
        has = s > 0
        top = stack[lanes, (s - 1).clamp_min(0)]
        cur[lanes] = torch.where(has, top, 0)
        sp[lanes] = torch.where(has, s - 1, s)
        popped[lanes] = has

    while True:
        lanes = (cur != 0).nonzero().flatten()
        if lanes.numel() == 0:
            break
        c_now = cur[lanes]
        inner, leaf = lanes[c_now > 0], lanes[c_now < 0]
        if inner.numel():
            node = cur[inner] - 1
            if visits is not None:
                visits["nodes"].append(node)
            c = closest[inner]
            box = bounds[node]  # [M, 4, 6]
            r = refs[node]      # [M, 4]
            h = slab_entry(box[..., 0:3], box[..., 3:6], o[inner][:, None],
                           inv[inner][:, None], neg[inner][:, None],
                           c[:, None].expand(-1, 4))
            hit = (r != 0) & (h < c[:, None])
            key = torch.where(hit, h, float("inf"))
            order = torch.sort(key, dim=1, stable=True).indices
            sref = r.gather(1, order)
            nhit = hit.sum(dim=1)
            cnt[0, inner] += (nhit >= 2).to(torch.int64)
            cnt[1, inner] += (nhit == 1).to(torch.int64)
            cnt[4, inner] += 1
            s = sp[inner]
            if bool((s + nhit - 1 > cap).any()):
                raise RuntimeError(f"BVH4 ref stack overflow: a ray needs "
                                   f"more than stack_cap = {cap} entries")
            for q in range(3):  # push far-first: sref[nhit-1] .. sref[1]
                push = q < nhit - 1
                val = sref.gather(1, (nhit - 1 - q).clamp_min(0)[:, None])
                stack[inner[push], (s + q)[push]] = val[push, 0]
            desc = nhit > 0
            sp[inner] = torch.where(desc, s + nhit - 1, s)
            cur[inner] = torch.where(desc, sref[:, 0], cur[inner])
            popped[inner[desc]] = False
            pop(inner[~desc])
            # rays that descended into a leaf visit it in the same pass
            now_leaf = inner[desc & (sref[:, 0] < 0)]
            leaf = torch.cat([leaf, now_leaf])
        if leaf.numel():
            cl = -cur[leaf] - 1
            if visits is not None:
                visits["leaves"].append(cl)
            base = cl * w
            rows = tabs.tri[base[:, None] + slots]  # [M, width, 12]
            hit, new_c, j, first = leaf_step(rows, o[leaf], d[leaf], t_min,
                                             closest[leaf])
            cnt[2, leaf] += 1
            cnt[3, leaf] += popped[leaf].to(torch.int64)
            if any_hit:
                # the walk ends at the first slot hit
                occ[leaf] = hit
                best[leaf] = torch.where(hit, base + first, best[leaf])
                cur[leaf[hit]] = 0
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
    lib = _build.load("bvh4")
    fn = lib.bvh4_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([ctypes.c_int] + [p] * 10
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int] + [p] * 6)
        fn.restype = ctypes.c_int
        lib.bvh4_stack_capacity.restype = ctypes.c_int
        if lib.bvh4_stack_capacity() != STACK_CAPACITY:
            raise RuntimeError("csrc/bvh4.cu kStackCap differs from "
                               "STACK_CAPACITY")
    return lib


def _launch(mode: int, origin: V3, direction: V3, tmax: torch.Tensor,
            tabs: Bvh4Tables, t_min: float):
    """Check the inputs, allocate the outputs and launch one mode of the
    kernel on the current stream."""
    if tabs.stack_cap > STACK_CAPACITY:
        raise ValueError(f"BVH4 tables need a ref stack of {tabs.stack_cap}"
                         f" entries; the kernel holds {STACK_CAPACITY}")
    dev = origin.x.device
    n = origin.x.shape[0]
    f32 = torch.float32
    for name, a in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t_max"),
                       (*origin, *direction, tmax)):
        _check(name, a, dev, f32, (n,))
    n_nodes = tabs.refs.shape[0] // 4
    _check("bounds", tabs.bounds, dev, f32, (n_nodes * 24,))
    _check("refs", tabs.refs, dev, torch.int32, (n_nodes * 4,))
    _check("overflow", tabs.overflow, dev, torch.int32, (1,))
    s = tabs.tri.shape[0]
    if s % tabs.width:
        raise ValueError(f"{s} triangle slots are not whole clusters of "
                         f"{tabs.width}")
    _check("triangles", tabs.tri, dev, f32, (s, 12))
    if tabs.tri.data_ptr() % 16:
        raise ValueError("triangle table must be 16-byte aligned (float4)")
    if tabs.bounds.data_ptr() % 16 or tabs.refs.data_ptr() % 16:
        raise ValueError("bounds and refs must be 16-byte aligned (float4, "
                         "int4)")
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
            rc = _lib().bvh4_launch(
                mode, *(a.data_ptr() for a in (*origin, *direction, tmax)),
                tabs.bounds.data_ptr(), tabs.refs.data_ptr(),
                tabs.tri.data_ptr(), tabs.width, tabs.stack_cap,
                float(t_min), n, ptr(t_out), ptr(tri_out), ptr(occ_out),
                cnt.data_ptr(), tabs.overflow.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"BVH4 kernel launch failed: CUDA error {rc}")
        LAUNCHES[_MODE_NAMES[mode]] += 1
    return t_out, tri_out, occ_out, cnt


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _bvh4_trace_ref(origin: V3, direction: V3, t_max, tabs: Bvh4Tables,
                    t_min: float):
    tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
    t, tri, _, cnt = _bvh4_walk_ref(origin, direction, tmax, tabs, t_min,
                                    any_hit=False)
    return t, tri, cnt


def _bvh4_occluded_ref(origin: V3, direction: V3, t_max, tabs: Bvh4Tables,
                       t_min: float):
    tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
    _, _, occ, cnt = _bvh4_walk_ref(origin, direction, tmax, tabs, t_min,
                                    any_hit=True)
    return occ, cnt


def bvh4_trace(origin: V3, direction: V3, t_max, tabs: Bvh4Tables,
               t_min: float) -> Tuple[torch.Tensor, ...]:
    """Nearest hit: (t [N], the ray's t_max on a miss; tri [N] int32 SAH
    slot, -1 on a miss; counters [5, N] int32). On the card a ray whose
    stack would overflow stops with leaf_pop = -1 and sets
    ``tabs.overflow``, which :func:`check_stack` raises for; the plain
    version raises at once."""
    if _on_cuda(origin):
        tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
        t, tri, _, cnt = _launch(_NEAREST, origin, direction, tmax, tabs,
                                 t_min)
        return t, tri, cnt
    return _bvh4_trace_ref(origin, direction, t_max, tabs, t_min)


def bvh4_occluded(origin: V3, direction: V3, t_max, tabs: Bvh4Tables,
                  t_min: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any hit in (t_min, t_max): (occ [N] bool, counters [5, N] int32).
    Lanes with t_max <= 0 test nothing. A stack overflow is handled as in
    :func:`bvh4_trace`."""
    if _on_cuda(origin):
        tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
        _, _, occ, cnt = _launch(_ANY_HIT, origin, direction, tmax, tabs,
                                 t_min)
        return occ, cnt
    return _bvh4_occluded_ref(origin, direction, t_max, tabs, t_min)
