"""Nearest ray-triangle hit over the heap BVH with a regrouped leaf phase
(``config.regroup``): the CUDA kernel ``csrc/bvh_rg.cu`` and its plain
PyTorch version (counterpart of ``tpu_pathtracer/ops/pallas_bvh_rg.py``:
``_kernel_nearest_rg`` through ``packet_trace_rg``).

The walk is the heap kernel's (``ops/cuda_bvh.py``), but a leaf visit is
only recorded. Each ray walks in rounds: it records up to ``WINDOW`` leaf
visits, against the closest hit committed at the end of the last round;
then every recorded (ray, leaf) pair is tested with the exact
Möller–Trumbore of the heap kernel, against that same committed closest,
and each ray commits the minimum of (t, triangle slot) over its pairs.
So every accepted hit is exact, the per-ray minimum does not depend on
the order of the tests, t equals the heap kernel's for the same winner,
winners differ from it only where two slots give the same t, and the
deferred commits can only add leaf visits. A ray's result and counters
depend on its own walk alone, so the kernel (whose threads walk a ray
each and whose warps test each ray's window as soon as it is full, its
slots spread over several lanes and merged by shuffles) and the plain
version agree bit for bit, counters included.

The TPU kernel's ``regroup_dense`` threshold picks between its two leaf
paths, which give the same t (``pallas_bvh_rg.py:639``); a per-ray walk
has no such choice, so the port accepts the knob with no effect, as it
does ``packet_width``. Shadow rays under ``regroup`` take the heap
any-hit kernel (``engine/wavefront.py``), as the JAX package sends them.

The public function dispatches on the device of its inputs: tensors on
the CPU go to the plain version, tensors on a CUDA device to the kernel
(or the call raises). There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as _cb
from tpu_pathtracer_torch.ops.cuda_spheres import _on_cuda, _tmax_vector
from tpu_pathtracer_torch.ops.v3 import V3

# Kernel launches by the wrapper below. Callers reset it to 0 and read it
# back to show that a run went through the kernel.
LAUNCHES = {"nearest": 0}

# Leaf visits a ray records before its pairs are tested: csrc/bvh_rg.cu's
# kWindow, which says why 2.
WINDOW = 2
_MAX_SLOTS = (1 << 31) - 1  # the kernel keeps a heap slot in an int
_VISIT_CHUNK = 16384    # recorded visits a plain flush tests at once


def _rg_walk_ref(origin: V3, direction: V3, tmax: torch.Tensor,
                 tabs: _cb.HeapTables, t_min: float, visits=None,
                 windows=None):
    """(closest [N], tri [N] int32, counters [5, N] int32): every ray's
    windows, the k-th of all rays at once. ``visits`` as for
    ``cuda_bvh.HeapWalk``; ``windows``, if given, gathers each round's
    recorded pairs as (rays, leaves), two int64 tensors."""
    walk = _cb.HeapWalk(origin, direction, tmax, tabs, visits)
    n = walk.o.shape[0]
    dev = walk.o.device
    P = tabs.prims_per_leaf
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    slots = torch.arange(P, device=dev)
    big = torch.iinfo(torch.int64).max
    while True:
        # walk: up to WINDOW leaf visits a ray, culled by the committed
        # closest; a recorded visit pops at once
        rec = torch.zeros((n,), dtype=torch.int64, device=dev)
        ray_of, base_of = [], []
        while True:
            lanes = ((walk.idx > 0) & (rec < WINDOW)).nonzero().flatten()
            if lanes.numel() == 0:
                break
            inner, leaf = walk.split(lanes)
            if inner.numel():
                walk.node_step(inner)
            if leaf.numel():
                ray_of.append(leaf)
                base_of.append(walk.visit_leaf(leaf))
                rec[leaf] += 1
                walk.pop(leaf)
        if not ray_of:
            break
        # flush: every recorded (ray, leaf) pair against the ray's
        # committed closest; per ray the minimum of (t, slot)
        ray_of, base_of = torch.cat(ray_of), torch.cat(base_of)
        if windows is not None:
            windows.append((ray_of, base_of // P))
        t_v, s_v = [], []
        for s in range(0, ray_of.numel(), _VISIT_CHUNK):
            r = ray_of[s:s + _VISIT_CHUNK]
            ids = base_of[s:s + _VISIT_CHUNK, None] + slots  # [V, P]
            t, ok = _cb.mt_rows(tabs.tri[ids], walk.o[r], walk.d[r], t_min,
                                walk.closest[r])
            t = torch.where(t == 0.0, 0.0, t)  # one zero: -0 ties +0
            tmin = torch.where(ok, t, float("inf")).min(dim=1).values
            s_min = torch.where(ok & (t == tmin[:, None]), ids, big)
            t_v.append(tmin)
            s_v.append(s_min.min(dim=1).values)
        t_v, s_v = torch.cat(t_v), torch.cat(s_v)
        t_ray = torch.full((n,), float("inf"), device=dev).scatter_reduce(
            0, ray_of, t_v, "amin")
        s_ray = torch.full((n,), big, dtype=torch.int64,
                           device=dev).scatter_reduce(
            0, ray_of, torch.where(t_v == t_ray[ray_of], s_v, big), "amin")
        hit = s_ray < big
        walk.closest = torch.where(hit, t_ray, walk.closest)
        best = torch.where(hit, s_ray, best)
    return walk.closest, best.to(torch.int32), walk.cnt.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("bvh_rg")
    fn = lib.bvh_rg_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 9 + [i, i, ctypes.c_float, i] + [p] * 4)
        fn.restype = ctypes.c_int
    return lib


def _launch(origin: V3, direction: V3, tmax: torch.Tensor,
            tabs: _cb.HeapTables, t_min: float):
    """Check the inputs, allocate the outputs and launch the kernel on the
    current stream."""
    if tabs.tri.shape[1:] != (12,):
        raise ValueError("triangle rows must be [T, 12]")
    dev, n = _cb.check_walk_inputs(origin, direction, tmax, tabs, tabs.tri,
                                   "triangle")
    f32 = torch.float32
    if tabs.first_leaf * tabs.prims_per_leaf > _MAX_SLOTS:
        raise ValueError(f"{tabs.first_leaf} leaves of "
                         f"{tabs.prims_per_leaf}: the regrouped kernel "
                         f"numbers at most {_MAX_SLOTS} heap slots")
    cnt = torch.empty((5, n), dtype=torch.int32, device=dev)
    t_out = torch.empty((n,), dtype=f32, device=dev)
    tri_out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().bvh_rg_launch(
                *(a.data_ptr() for a in (*origin, *direction, tmax)),
                tabs.nodes.data_ptr(), tabs.tri.data_ptr(), tabs.first_leaf,
                tabs.prims_per_leaf, float(t_min), n,
                t_out.data_ptr(), tri_out.data_ptr(), cnt.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"regrouped BVH kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES["nearest"] += 1
    return t_out, tri_out, cnt


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def _rg_trace_ref(origin: V3, direction: V3, t_max, tabs: _cb.HeapTables,
                  t_min: float):
    tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
    return _rg_walk_ref(origin, direction, tmax, tabs, t_min)


def rg_trace(origin: V3, direction: V3, t_max, tabs: _cb.HeapTables,
             t_min: float) -> Tuple[torch.Tensor, ...]:
    """Nearest hit: (t [N], the ray's t_max on a miss; tri [N] int32 heap
    slot, -1 on a miss; counters [5, N] int32), as ``cuda_bvh.heap_trace``
    returns them. Lanes with t_max <= 0 test nothing."""
    if _on_cuda(origin):
        tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
        return _launch(origin, direction, tmax, tabs, t_min)
    return _rg_trace_ref(origin, direction, t_max, tabs, t_min)
