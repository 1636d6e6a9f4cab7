"""The heap walk's node phase with R rays a thread (K16): the CUDA kernel
``csrc/dual_probe.cu``, its plain PyTorch version, and the probe that asks
whether walking several independent rays in turn hides the node step's
latency. The port's counterpart of ``experiments/dual_probe.py``
(``_kernel``, through ``probe``), where P independent 1024-ray packets
share a TPU block.

    python -m tpu_pathtracer_torch.experiments.dual_probe [--dragon-ish] [R ...]

The function is each ray's count of interior steps of K5's walk
(``ops/cuda_bvh.py``) with closest fixed at FLT_MAX and leaves popping at
once; R (1, 2 or 4) changes only how the kernel schedules it, so every R
agrees bit for bit with the plain version (``cuda_bvh``'s heap walk with
a leaf step that does nothing). :func:`dual_steps` dispatches on the
device of its inputs: CPU tensors go to the plain version, CUDA tensors to
the kernel or the call raises.

``main()`` builds ``knot_zoo_scene(512, 512, prims_per_leaf=64)``
(``--dragon-ish``: nu=832, nv=131) and takes the 131,072 diffuse bounce
stand-ins of ``experiments/incoh_phase.py``'s ``bounce_rays`` (its numpy
generator, copied in :func:`bounce_rays`: the same rays, unsorted, ROADMAP
A-12). That generator draws from every heap slot, the sentinel padding
too, whose rays have non-finite origins and pass every slab test (ROADMAP
C-16); ``main()`` drops them and says how many, and how many steps they
would have taken. It runs :func:`measure` on the rest: every R held
bit-equal to the plain node phase, then the R forms timed in turns (4
rounds forward and back, each reading the median of 7 calls); it prints
ms a traversal and ns an interior step for each.
"""

from __future__ import annotations

import ctypes
import statistics
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.experiments.common import (card, distinct, in_turns,
                                                     median_ms)
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops.cuda_spheres import _check, _on_cuda
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

RAYS_PER_THREAD = (1, 2, 4)
# Kernel launches by dual_steps, per R ("r1", "r2", "r4"). Callers reset
# them to 0 and read them back to show that a run went through the kernel.
LAUNCHES = {f"r{r}": 0 for r in RAYS_PER_THREAD}
BOUNCE_RAYS = 131_072  # experiments/incoh_phase.py:30
ROUNDS = 4
DRAGON_ISH = {"nu": 832, "nv": 131}


@np.errstate(invalid="ignore")  # a sentinel slot's inf - inf
def bounce_rays(mesh, n: int = BOUNCE_RAYS) -> Tuple[np.ndarray, np.ndarray]:
    """``experiments/incoh_phase.py`` ``bounce_rays``' diffuse bounce
    stand-ins on ``mesh``, before its sort: origins on random surface
    points (1e-3 off the face), cosine-hemisphere directions around the
    face normal, from ``default_rng(7)``. Returns (origin, direction), each
    float32 [n, 3]. Like the original it draws from every heap slot
    (``num_tris``), sentinel padding included."""
    nt = int(mesh.num_tris)
    rng = np.random.default_rng(7)
    ti = rng.integers(0, nt, n)
    v0 = mesh.v0.cpu().numpy()[ti]
    e1 = mesh.v1.cpu().numpy()[ti] - v0
    e2 = mesh.v2.cpu().numpy()[ti] - v0
    r1, r2 = rng.random(n), rng.random(n)
    flip = r1 + r2 > 1.0
    r1 = np.where(flip, 1.0 - r1, r1)
    r2 = np.where(flip, 1.0 - r2, r2)
    p = v0 + r1[:, None] * e1 + r2[:, None] * e2
    nrm = np.cross(e1, e2)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    u1, u2 = rng.random(n), rng.random(n)
    r = np.sqrt(u1)
    phi = 2 * np.pi * u2
    lx, ly, lz = r * np.cos(phi), r * np.sin(phi), np.sqrt(1 - u1)
    a = np.where(np.abs(nrm[:, 2:3]) < 0.9, [0.0, 0.0, 1.0], [1.0, 0.0, 0.0])
    t1 = np.cross(a, nrm)
    t1 /= np.maximum(np.linalg.norm(t1, axis=1, keepdims=True), 1e-12)
    t2 = np.cross(nrm, t1)
    d = lx[:, None] * t1 + ly[:, None] * t2 + lz[:, None] * nrm
    o = p + 1e-3 * nrm
    return o.astype(np.float32), d.astype(np.float32)


def _dual_steps_ref(origin: V3, direction: V3, tabs: cb.HeapTables,
                    visits: Optional[dict] = None) -> torch.Tensor:
    """int32 [N]: each ray's interior steps of the heap walk with closest
    at FLT_MAX and leaves popping at once (``node_steps`` of
    ``cuda_bvh``'s walk). ``visits`` as for ``cuda_bvh.HeapWalk``."""
    tmax = torch.full_like(origin.x, FLT_MAX)

    def pop_at_once(walk, lanes, base):
        none = torch.zeros_like(lanes, dtype=torch.bool)
        return none, walk.closest[lanes], torch.zeros_like(lanes), \
            torch.zeros_like(lanes)

    *_, cnt = cb._heap_walk_ref(origin, direction, tmax, tabs, 0.0,
                                any_hit=False, visits=visits,
                                leaf_test=pop_at_once)
    return cnt[4]


def _lib() -> ctypes.CDLL:
    lib = _build.load("dual_probe")
    fn = lib.dual_probe_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([ctypes.c_int] + [p] * 7
                       + [ctypes.c_int, ctypes.c_int, p, p])
        fn.restype = ctypes.c_int
    return lib


def dual_steps(origin: V3, direction: V3, tabs: cb.HeapTables,
               R: int = 1) -> torch.Tensor:
    """Each ray's interior steps (int32 [N]) of the node phase, walked R
    rays a thread on the card."""
    if R not in RAYS_PER_THREAD:
        raise ValueError(f"R must be one of {RAYS_PER_THREAD}, not {R}")
    if not _on_cuda(origin):
        return _dual_steps_ref(origin, direction, tabs)
    dev = origin.x.device
    n = origin.x.shape[0]
    for name, a in zip(("ox", "oy", "oz", "dx", "dy", "dz"),
                       (*origin, *direction)):
        _check(name, a, dev, torch.float32, (n,))
    _check("nodes", tabs.nodes, dev, torch.float32,
           (2 * tabs.first_leaf, 8))
    if tabs.nodes.data_ptr() % 16:
        raise ValueError("the node table must be 16-byte aligned (float4)")
    if max(tabs.first_leaf, 1).bit_length() > 32:
        raise ValueError("BVH deeper than the 32-level uint32 bitstack")
    steps = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().dual_probe_launch(
                R, *(a.data_ptr() for a in (*origin, *direction)),
                tabs.nodes.data_ptr(), tabs.first_leaf, n, steps.data_ptr(),
                stream)
        if rc != 0:
            raise RuntimeError(f"dual_probe kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES[f"r{R}"] += 1
    return steps


def measure(origin: V3, direction: V3, tabs: cb.HeapTables,
            rays_per_thread=RAYS_PER_THREAD, rounds: int = ROUNDS) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 10d print it): each R runs once and is held
    bit-equal to the plain node phase, then the R forms are timed in turns.
    Returns a dict: ``launches`` (LAUNCHES after the checked run),
    ``total`` (interior steps), ``nodes`` (the distinct node rows read),
    ``readings`` and ``ms`` (their median) by R, and ``plain_ms``."""
    steps = {r: dual_steps(origin, direction, tabs, r)
             for r in rays_per_thread}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    visits = {"nodes": [], "leaves": []}
    want = _dual_steps_ref(origin, direction, tabs, visits)
    for r, got in steps.items():
        if not torch.equal(got, want):
            raise AssertionError(f"R={r}: step counts differ from the plain "
                                 f"node phase on {int((got != want).sum())} "
                                 f"rays")
    plain_ms = median_ms(lambda: _dual_steps_ref(origin, direction, tabs),
                         reps=2)
    readings = in_turns({r: (lambda r=r: dual_steps(origin, direction, tabs,
                                                    r))
                         for r in rays_per_thread}, rounds)
    return {"launches": launches, "total": int(want.sum(dtype=torch.int64)),
            "nodes": distinct(visits["nodes"]), "readings": readings,
            "ms": {r: statistics.median(v) for r, v in readings.items()},
            "plain_ms": plain_ms}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    mesh_kw = {}
    if argv and argv[0] == "--dragon-ish":
        mesh_kw = DRAGON_ISH
        argv = argv[1:]
    rs = [int(r) for r in argv] or list(RAYS_PER_THREAD)
    dev = card("dual_probe")
    scene, _ = knot_zoo_scene(512, 512, prims_per_leaf=64, device=dev,
                              **mesh_kw)
    o, d = bounce_rays(scene.mesh)
    live = np.isfinite(o).all(1) & np.isfinite(d).all(1)
    to = lambda a, m: V3(*(torch.from_numpy(np.ascontiguousarray(a[m, k]))
                           .to(dev) for k in range(3)))
    tabs = cb.heap_tables(scene.mesh)
    dropped = dual_steps(to(o, ~live), to(d, ~live), tabs)
    r = measure(to(o, live), to(d, live), tabs, rs)
    total = r["total"]
    lost = int(dropped.sum(dtype=torch.int64))
    print(f"knot {scene.mesh.num_tris} slots, first_leaf {tabs.first_leaf}: "
          f"{o.shape[0]} bounce rays drawn, {int((~live).sum())} with a "
          f"sentinel slot's non-finite origin dropped (they would walk "
          f"{lost / max(dropped.numel(), 1):.1f} interior steps a ray, "
          f"{lost / max(lost + total, 1):.1%} of all), {int(live.sum())} "
          f"walked; {total} interior steps ({total / live.sum():.1f} a ray, "
          f"bit-equal to the plain node phase at every R; plain "
          f"{r['plain_ms']:.1f} ms)", flush=True)
    for k in rs:
        ms, readings = r["ms"][k], r["readings"][k]
        print(f"  R={k}: {ms:7.3f} ms/trav (readings {min(readings):.3f}-"
              f"{max(readings):.3f}) -> {ms * 1e6 / total:6.3f} ns/step",
              flush=True)


if __name__ == "__main__":
    main()
