"""The heap walk's node phase with R rays a thread (K16): the CUDA kernel
``csrc/dual_probe.cu``, its plain PyTorch version, and the probe that asks
whether walking several independent rays in turn hides the node step's
latency. The port's counterpart of ``experiments/dual_probe.py``
(``_kernel``, through ``probe``), where P independent 1024-ray packets
share a TPU block.

    python -m tpu_pathtracer_torch.experiments.dual_probe [--dragon-ish] [R ...]
    python -m tpu_pathtracer_torch.experiments.dual_probe parent=FILE.cu \\
        [NAME=FILE.cu] [NAME=K:V,...] [NAME=yardstick:MODULE] [--out DIR]

The function is each ray's count of interior steps of K5's walk
(``ops/cuda_bvh.py``) with closest fixed at FLT_MAX and leaves popping at
once; R (1, 2 or 4) changes only how the kernel schedules it, so every R
agrees bit for bit with the plain version (``cuda_bvh``'s heap walk with
a leaf step that does nothing). :func:`dual_steps` dispatches on the
device of its inputs: CPU tensors go to the plain version, CUDA tensors to
the kernel or the call raises. The kernel runs one persistent wave with
the same resident warps an SM at every R (:func:`wave`), its threads
taking rays from their warp's claims on a counter as their slots free
up.

``main()`` builds ``knot_zoo_scene(512, 512, prims_per_leaf=64)``
(``--dragon-ish``: nu=832, nv=131) and takes the 131,072 diffuse bounce
stand-ins of ``experiments/incoh_phase.py``'s ``bounce_rays`` (its numpy
generator, copied in :func:`bounce_rays`: the same rays, unsorted, ROADMAP
A-12). That generator draws from every heap slot, the sentinel padding
too, whose rays have non-finite origins and pass every slab test (ROADMAP
C-16); ``main()`` walks them apart, held bit-equal too, and says how many
and how many steps they took. It runs :func:`measure` on the rest: every R
held bit-equal to the plain node phase, then the R forms timed in turns,
device time a call in a CUDA graph; it prints ms a traversal and ns an
interior step for each, and the resident warps an SM.

With sources (``parent=FILE.cu``, say the first form: commit bb9225d's
``csrc/dual_probe.cu`` saved under a gitignored directory; ``NAME=FILE.cu``;
``NAME=K:V,...``, this source with its ``constexpr int K`` set to V, say
``w8=kWarpsPerSm:8``; ``NAME=yardstick:MODULE``, a patch of this source in
``experiments/yardsticks``, say ``top=yardstick:dual_treelet``) it runs the
A/B instead (:func:`ab`): on :func:`ray_sets`' three sets (the dragon
frame's 131,072 primary rays of ``chip_smoke.py`` phase 10d, its
196,608-lane pool primary and the knot's finite bounce rays above) each
source at every R held bit-equal to the plain node phase, then timed in
turns, device time a call in a CUDA graph; it prints ns an interior step,
the resident warps an SM, the issue-rate floor of each build's SASS
(:func:`walk_sass`) and the latency floor with K17a's round trips, ``l2``
and ``smem``, measured in the same call (``tpu_micro.round_trips``); for
a source with the ``dual_trace`` yardstick's counters
(``yardstick:dual_trace``) it prints what :func:`trace` reads. ``--out DIR`` keeps each build's ptxas lines
and SASS.
"""

from __future__ import annotations

import ctypes
import math
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.experiments import iter_ablate as ia
from tpu_pathtracer_torch.experiments import tpu_micro as um
from tpu_pathtracer_torch.experiments.common import (ISSUE_RATE, ab_texts,
                                                     build, card, distinct,
                                                     fast_count,
                                                     graph_readings,
                                                     branch_target,
                                                     median_ms, natural_loops,
                                                     opcode, package_ptxas,
                                                     sass_dump,
                                                     sass_functions,
                                                     split_ab)
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
ROUNDS = 3        # rounds in turns
GRAPH_CALLS = 20  # calls a CUDA graph
DRAGON_ISH = {"nu": 832, "nv": 131}
THREADS = 128     # csrc/dual_probe.cu kThreads
OUT_OF_RESOURCES = 701  # cudaErrorLaunchOutOfResources: the wave does not fit
# one warp issues one instruction a cycle at the H100 SXM's 1,980 MHz
WARP_ISSUE_RATE = 1.98e9


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




def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (the package's build or another source's) with its C
    entries' signatures set: ``dual_probe_walk`` and ``dual_probe_shape``,
    or the first form's ``dual_probe_launch`` (no counter, a grid of
    n / (128 R) blocks), and ``dual_trace``'s ``dual_probe_trace``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    for name, args in (("dual_probe_walk", [i] + [p] * 7 + [i, i, p, p, p]),
                       ("dual_probe_launch", [i] + [p] * 7 + [i, i, p, p]),
                       ("dual_probe_shape", [i, ip, ip, ip]),
                       ("dual_probe_trace", [p, i, p, i, p])):
        fn = getattr(lib, name, None)
        if fn is not None and fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return bind(_build.load("dual_probe"))


def _walk(origin: V3, direction: V3, tabs: cb.HeapTables, R: int,
          lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """One launch through ``lib`` (default: the package's build, counted
    in LAUNCHES; another library's launches are not counted)."""
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
        own = lib or _lib()
        args = (R, *(a.data_ptr() for a in (*origin, *direction)),
                tabs.nodes.data_ptr(), tabs.first_leaf, n, steps.data_ptr())
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if hasattr(own, "dual_probe_walk"):
                counter = torch.empty((1,), dtype=torch.int32, device=dev)
                rc = own.dual_probe_walk(*args, counter.data_ptr(), stream)
            else:  # the first form
                rc = own.dual_probe_launch(*args, stream)
        if rc != 0:
            raise RuntimeError(f"dual_probe kernel launch failed: CUDA error "
                               f"{rc}")
        if lib is None:
            LAUNCHES[f"r{R}"] += 1
    return steps


def dual_steps(origin: V3, direction: V3, tabs: cb.HeapTables,
               R: int = 1) -> torch.Tensor:
    """Each ray's interior steps (int32 [N]) of the node phase, walked R
    rays a thread on the card."""
    if R not in RAYS_PER_THREAD:
        raise ValueError(f"R must be one of {RAYS_PER_THREAD}, not {R}")
    if not _on_cuda(origin):
        return _dual_steps_ref(origin, direction, tabs)
    return _walk(origin, direction, tabs, R)


def wave(R: int, lib: Optional[ctypes.CDLL] = None) -> Tuple[int, int, int]:
    """The R form's launch on the current card: (blocks, blocks of 128 it
    puts on an SM, the most that fit there by the occupancy calculator).
    Raises on a CUDA error other than the wave not fitting."""
    grid, per_sm, resident = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int())
    rc = (lib or _lib()).dual_probe_shape(R, ctypes.byref(grid),
                                          ctypes.byref(per_sm),
                                          ctypes.byref(resident))
    if rc not in (0, OUT_OF_RESOURCES):
        raise RuntimeError(f"dual_probe_shape failed: CUDA error {rc}")
    return grid.value, per_sm.value, resident.value


def lanes(R: int, lib: Optional[ctypes.CDLL] = None) -> int:
    """The threads of the R form's wave: it seats its first R x lanes
    rays with no counter."""
    return wave(R, lib)[0] * THREADS


def warps_per_sm(R: int, lib: Optional[ctypes.CDLL] = None) -> int:
    """The resident warps an SM of the R form's wave; raises if fewer of
    its blocks fit on an SM than it launches there (the C entry then
    refuses to launch)."""
    grid, per_sm, resident = wave(R, lib)
    if resident < per_sm:
        raise RuntimeError(f"R={R}: {resident} blocks of {THREADS} fit on an "
                           f"SM, the wave puts {per_sm} there")
    return per_sm * THREADS // 32


def first_form_warps(n: int, R: int, sms: int) -> int:
    """The first form's warps an SM at ``n`` rays (bb9225d's grid of
    n / (128 R) blocks of 128 spread evenly over ``sms`` SMs), at most 64
    (2,048 threads an SM) whatever its registers allow."""
    return min(math.ceil(math.ceil(n / (THREADS * R)) / sms), 16) * 4


def walk_sass(text: str) -> Dict[int, Tuple[int, int, int, int]]:
    """{R: (a pass's instructions, a refill's, atomics, a seat's)} of each
    R form's walk loop in a ``cuobjdump -sass`` dump (``dual_kernel<R>``):
    the widest natural loop (``common.natural_loops``) that holds the
    refill's atomic (``ATOMG``, or ``ATOM``/``RED``). The refill is the
    stretch that the loop's first branch after its ballot (a ``VOTE.ANY``
    into a register) jumps over when no lane wants a ray. A seat is a
    stretch of the rest that a forward branch jumps over when its slot
    holds no newly seated ray: one that holds the ray's reciprocals
    (``MUFU.RCP``) and no slab test (``FMNMX``); the R of them are counted
    as one slot's (0 if the loop holds none). A pass is the rest: a node
    step (or pop) of each of the R slots of a warp's 32 lanes. Each is
    counted once, but the slow paths of the IEEE divisions
    (``common.fast_count``). Raises if a form's loop holds no atomic
    (another form, say the first), no refill stretch holds it, or there
    is no ``dual_kernel``."""
    out = {}
    for name, code in sass_functions(text).items():
        m = re.search(r"dual_kernelILi(\d+)E", name)
        if not m:
            continue
        what = f"dual_kernel<{m.group(1)}>"
        count = lambda s, ops: sum(opcode(i).startswith(ops)
                                   for _, i in code[s[0]:s[1] + 1])
        loops = [s for s in natural_loops(code)
                 if count(s, ("ATOM", "RED"))]
        if not loops:
            raise ValueError(f"{what}: no loop holds the refill's atomic")
        lo, hi = max(loops, key=lambda s: s[1] - s[0])
        addr = {a: k for k, (a, _) in enumerate(code)}
        forward = lambda k: (code[k][1].startswith("@")
                             and branch_target(code[k][1]) in addr
                             and k < addr[branch_target(code[k][1])] <= hi)
        ballot = next((k for k in range(lo, hi + 1) if re.match(
            r"(@!?U?P\w+\s+)?VOTE\.ANY R", code[k][1])), None)
        jump = next((k for k in range(ballot or hi, hi + 1) if forward(k)),
                    None) if ballot is not None else None
        if jump is None:
            raise ValueError(f"{what}: no branch over a refill after a "
                             f"ballot")
        refill = (jump + 1, addr[branch_target(code[jump][1])] - 1)
        if not count(refill, ("ATOM", "RED")):
            raise ValueError(f"{what}: the refill holds no atomic")
        seats, k = [], lo
        while k <= hi:
            if refill[0] <= k <= refill[1] or not forward(k):
                k += 1
                continue
            s = (k + 1, addr[branch_target(code[k][1])] - 1)
            if count(s, ("MUFU.RCP",)) and not count(s, ("FMNMX", "ATOM",
                                                         "RED")):
                seats.append(s)
                k = s[1] + 1
            else:
                k += 1
        seat = sum(fast_count(code, s) for s in seats)
        total, part = fast_count(code, (lo, hi)), fast_count(code, refill)
        r = int(m.group(1))
        out[r] = (total - part - seat, part, count((lo, hi), ("ATOM", "RED")),
                  round(seat / r))
    if not out:
        raise ValueError("no dual_kernel in the SASS")
    return out


def issue_floor_ms(sass: Tuple[int, int, int, int], steps: int, rays: int,
                   R: int, lanes: int) -> float:
    """The least time the card could issue a run of ``rays`` rays and
    ``steps`` interior steps (:func:`walk_sass`'s (pass, refill, _, seat))
    on a wave of ``lanes`` threads: a pass for each step of each of the R
    slots of a warp's 32 lanes, a seat for every 32 rays, and a refill
    round for every 32 of the rays past the R x ``lanes`` that the wave
    seats with no refill, over 528 schedulers at 1,980 MHz."""
    refilled = max(rays - R * lanes, 0)
    return ((steps * sass[0] / R + refilled * sass[1] + rays * sass[3])
            / 32 / ISSUE_RATE * 1e3)


def latency_floor_ms(sass: Tuple[int, int, int, int], longest: int,
                     trip_ns: float) -> float:
    """The least time the longest ray's ``longest`` dependent steps take:
    each a pass of the walk loop issued by one warp (:func:`walk_sass`'s
    pass instructions at one a cycle, 1,980 MHz) and one round trip of its
    node loads (``trip_ns``: K17a's dependent load a step)."""
    return longest * (sass[0] / WARP_ISSUE_RATE * 1e9 + trip_ns) / 1e6


def hold(origin: V3, direction: V3, tabs: cb.HeapTables,
         rays_per_thread=RAYS_PER_THREAD,
         lib: Optional[ctypes.CDLL] = None,
         visits: Optional[dict] = None,
         want: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Runs each R form once through ``lib`` (default: the package's
    build, counted in LAUNCHES) and raises unless its counts equal the
    plain node phase's (``want``, else run here with ``visits``), bit
    for bit. Returns the plain counts."""
    steps = {r: _walk(origin, direction, tabs, r, lib)
             for r in rays_per_thread}
    torch.cuda.synchronize()
    if want is None:
        want = _dual_steps_ref(origin, direction, tabs, visits)
    for r, got in steps.items():
        if not torch.equal(got, want):
            raise AssertionError(f"R={r}: step counts differ from the plain "
                                 f"node phase on {int((got != want).sum())} "
                                 f"of {want.numel()} rays")
    return want


def trace(lib: ctypes.CDLL, origin: V3, direction: V3, tabs: cb.HeapTables,
          R: int, want: torch.Tensor) -> dict:
    """One launch through ``lib``, a build with the ``dual_trace``
    yardstick's counters, read back: ``passes`` (the most a warp ran),
    ``mean_passes`` (a warp's), ``refill_share`` and ``claim_share`` (the
    warps' passes that held a refill round, and a claim from the
    counter), ``longest_seated`` (the pass at which the ray with the most
    interior steps, ``want``'s, was seated) and ``latest`` (the latest
    seating pass)."""
    n, warps = origin.x.shape[0], lanes(R, lib) // 32
    seat, passes = (ctypes.c_int * n)(), (ctypes.c_int * warps)()
    stat = (ctypes.c_ulonglong * 2)()
    for k in range(2):  # zero it, then read this launch's
        rc = lib.dual_probe_trace(seat, n, passes, warps, stat)
        if rc:
            raise RuntimeError(f"dual_probe_trace failed: CUDA error {rc}")
        if k == 0:
            _walk(origin, direction, tabs, R, lib)
    seated = np.frombuffer(seat, dtype=np.int32)
    ran = np.frombuffer(passes, dtype=np.int32)
    total = max(int(ran.sum()), 1)
    return {"passes": int(ran.max()), "mean_passes": float(ran.mean()),
            "refill_share": stat[0] / total, "claim_share": stat[1] / total,
            "longest_seated": int(seated[int(want.argmax())]),
            "latest": int(seated.max())}


def measure(origin: V3, direction: V3, tabs: cb.HeapTables,
            rays_per_thread=RAYS_PER_THREAD, rounds: int = ROUNDS) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 10d print it): each R runs once and is held
    bit-equal to the plain node phase, then the R forms are timed in
    turns, device time a call in a CUDA graph (``common.graph_readings``,
    GRAPH_CALLS calls a graph, ``rounds`` rounds). Returns a dict:
    ``launches`` (LAUNCHES after the checked run), ``total`` (interior
    steps), ``longest`` (the most one ray takes), ``nodes`` (the distinct
    node rows read), ``warps`` (resident warps an SM), ``readings`` and
    ``ms`` (their median) by R, and ``plain_ms``."""
    visits = {"nodes": [], "leaves": []}
    want = hold(origin, direction, tabs, rays_per_thread, visits=visits)
    launches = dict(LAUNCHES)
    plain_ms = median_ms(lambda: _dual_steps_ref(origin, direction, tabs),
                         reps=2)
    readings = graph_readings(list(rays_per_thread), [0],
                              lambda r, _: dual_steps(origin, direction,
                                                      tabs, r),
                              rounds, GRAPH_CALLS)
    readings = {r: readings[r, 0] for r in rays_per_thread}
    return {"launches": launches, "total": int(want.sum(dtype=torch.int64)),
            "longest": int(want.max()) if want.numel() else 0,
            "nodes": distinct(visits["nodes"]),
            "warps": {r: warps_per_sm(r) for r in rays_per_thread},
            "readings": readings,
            "ms": {r: statistics.median(v) for r, v in readings.items()},
            "plain_ms": plain_ms}


def _cuda_v3(a: np.ndarray, dev) -> V3:
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(dev)
                for k in range(3)))


def knot_bounce(dev, mesh_kw=None):
    """(tables, finite rays, sentinel rays) of ``main()``'s set: the
    knot's (``knot_zoo_scene(512, 512, prims_per_leaf=64)``, ``mesh_kw``
    its nu and nv) :func:`bounce_rays`, split by whether origin and
    direction are finite; each set (origin, direction)."""
    scene, _ = knot_zoo_scene(512, 512, prims_per_leaf=64, device=dev,
                              **(mesh_kw or {}))
    o, d = bounce_rays(scene.mesh)
    live = np.isfinite(o).all(1) & np.isfinite(d).all(1)
    return (cb.heap_tables(scene.mesh),
            (_cuda_v3(o[live], dev), _cuda_v3(d[live], dev)),
            (_cuda_v3(o[~live], dev), _cuda_v3(d[~live], dev)))


def ray_sets(dev) -> Dict[str, tuple]:
    """The A/B's sets, {name: (origin, direction, tables)}: the dragon
    frame's 131,072 primary rays of ``chip_smoke.py`` phase 10d and its
    196,608-lane pool primary (``iter_ablate``'s ``--frame`` sets, K5's
    frame shape), and the knot's finite bounce rays (:func:`knot_bounce`,
    the TPU probe's set)."""
    dragon, _, frame = ia._frame_sets(dev)
    knot, bounce, _ = knot_bounce(dev)
    return {"dragon primary": (*frame["primary"], dragon),
            "dragon pool primary": (*frame["pool primary"], dragon),
            "knot bounce": (*bounce, knot)}


def ab(sets: Dict[str, tuple], libs: Dict[str, Optional[ctypes.CDLL]],
       rays_per_thread=RAYS_PER_THREAD, rounds: int = ROUNDS):
    """K16's A/B: each of ``libs`` ({name: library with a C entry of
    either form}, None the package's build) at every R held bit-equal to
    the plain node phase on each of ``sets`` ({name: (origin, direction,
    tables)}), then timed in turns, device time a call in a CUDA graph
    (``common.graph_readings``, GRAPH_CALLS calls a graph, ``rounds``
    rounds). Returns ({(name, set, R): median ms}, {set: (interior steps,
    the longest ray's)})."""
    steps = {}
    for s, (o, d, tabs) in sets.items():
        want = _dual_steps_ref(o, d, tabs)
        for name, lib in libs.items():
            try:
                hold(o, d, tabs, rays_per_thread, lib, want=want)
            except AssertionError as e:
                raise AssertionError(f"{name} on {s}: {e}") from None
        steps[s] = (int(want.sum(dtype=torch.int64)), int(want.max()))
    cells = [(s, r) for s in sets for r in rays_per_thread]
    readings = graph_readings(
        list(libs), cells,
        lambda n, c: _walk(*sets[c[0]], c[1], libs[n]), rounds, GRAPH_CALLS)
    return ({(n, *c): statistics.median(v) for (n, c), v in
             readings.items()}, steps)


def _ab_main(dev, texts: Dict[str, str], out: Optional[Path],
             rays_per_thread) -> None:
    """Build ``texts`` ({name: source}), run :func:`ab` on :func:`ray_sets`
    and print each source's ns an interior step beside its warps an SM,
    the issue-rate floor of its build and the latency floor with K17a's
    round trips measured in this call."""
    own = _build.build("dual_probe")
    dumps = {"new": sass_dump(own)}
    print("[build] new: " + " | ".join(package_ptxas("dual_probe")),
          flush=True)
    libs: Dict[str, Optional[ctypes.CDLL]] = {"new": None}
    with ThreadPoolExecutor(max(1, len(texts))) as ex:  # one nvcc a source
        built = dict(zip(texts, ex.map(
            lambda kv: build(f"dual_{kv[0]}", kv[1], out), texts.items())))
    for name, (path, ptxas) in built.items():
        libs[name] = bind(ctypes.CDLL(str(path)))
        dumps[name] = sass_dump(path)
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / "dual_new.sass").write_text(dumps["new"])
    sets = ray_sets(dev)
    trips = um.round_trips(um.probe_inputs(dev))
    r, steps = ab(sets, libs, rays_per_thread)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"K16: each source bit-equal to the plain node phase at every R on "
          f"every set; device time a call in a CUDA graph ({GRAPH_CALLS} "
          f"calls a graph), {ROUNDS} rounds in turns; K17a's round trips in "
          f"this call (1,024 lanes, device time in CUDA graphs): l2 "
          f"{trips['l2']:.1f} ns, smem {trips['smem']:.1f} ns", flush=True)
    traced = [k for k, v in libs.items() if hasattr(v, "dual_probe_trace")]
    for s, (o, d, tabs) in sets.items():
        total, longest = steps[s]
        n = o.x.shape[0]
        want = _dual_steps_ref(o, d, tabs) if traced else None
        print(f" {s}: {n} rays, first_leaf {tabs.first_leaf}, {total} "
              f"interior steps ({total / n:.1f} a ray, the longest "
              f"{longest})", flush=True)
        for name, lib in libs.items():
            try:
                sass = walk_sass(dumps[name])
            except ValueError:  # another form (the first)
                sass = {}
            for k in rays_per_thread:
                ms = r[name, s, k]
                if hasattr(lib or _lib(), "dual_probe_walk"):
                    warps = f"{warps_per_sm(k, lib)} warps an SM"
                    if name in traced:
                        tr = trace(lib, o, d, tabs, k, want)
                        warps += (
                            f"; passes: the most {tr['passes']}, a warp's "
                            f"mean {tr['mean_passes']:.1f}, "
                            f"{tr['refill_share']:.1%} with a refill round, "
                            f"{tr['claim_share']:.1%} with a claim; the "
                            f"longest ray seated at pass "
                            f"{tr['longest_seated']}, the last at "
                            f"{tr['latest']}")
                else:
                    warps = (f"{math.ceil(n / (THREADS * k))} blocks, up to "
                             f"{first_form_warps(n, k, sms)} warps an SM")
                floor = ""
                if k in sass:
                    lat = {m: latency_floor_ms(sass[k], longest, trips[m])
                           for m in trips}
                    issue = issue_floor_ms(sass[k], total, n, k,
                                           lanes(k, lib))
                    floor = (f"; loop {sass[k]} (a pass, a refill, "
                             f"atomics, a seat), issue-rate floor {issue:.4f} "
                             f"ms, latency floor {lat['l2']:.4f} (l2) / "
                             f"{lat['smem']:.4f} ms (smem)")
                print(f"  {name:10s} R={k}: {ms:.4f} ms, {ms * 1e6 / total:.3f}"
                      f" ns a step ({warps}{floor})", flush=True)


def main(argv=None) -> None:
    names, ab_args = split_ab(sys.argv[1:] if argv is None else argv)
    mesh_kw = {}
    if names and names[0] == "--dragon-ish":
        mesh_kw = DRAGON_ISH
        names = names[1:]
    rs = [int(r) for r in names] or list(RAYS_PER_THREAD)
    dev = card("dual_probe")
    if ab_args:
        texts, out = ab_texts(ab_args,
                              (_build.CSRC_DIR / "dual_probe.cu").read_text())
        _ab_main(dev, texts, out, rs)
        return
    tabs, (o, d), (so, sd) = knot_bounce(dev, mesh_kw)
    dropped = dual_steps(so, sd, tabs)
    if not torch.equal(dropped, _dual_steps_ref(so, sd, tabs)):
        raise AssertionError("the sentinel rays' step counts differ from the "
                             "plain node phase")
    r = measure(o, d, tabs, rs)
    total, n, lost = r["total"], o.x.shape[0], int(dropped.sum())
    print(f"knot first_leaf {tabs.first_leaf}: {n + so.x.shape[0]} bounce "
          f"rays drawn, {so.x.shape[0]} with a sentinel slot's non-finite "
          f"origin walked apart ({lost / max(dropped.numel(), 1):.1f} "
          f"interior steps a ray, {lost / max(lost + total, 1):.1%} of all, "
          f"bit-equal), {n} finite; {total} interior steps "
          f"({total / n:.1f} a ray, the longest {r['longest']}, bit-equal to "
          f"the plain node phase at every R; plain {r['plain_ms']:.1f} ms); "
          f"device time a call in a CUDA graph, {ROUNDS} rounds in turns",
          flush=True)
    for k in rs:
        ms, readings = r["ms"][k], r["readings"][k]
        print(f"  R={k}: {ms:7.4f} ms/trav (readings {min(readings):.4f}-"
              f"{max(readings):.4f}) -> {ms * 1e6 / total:6.3f} ns/step, "
              f"{r['warps'][k]} warps an SM", flush=True)


if __name__ == "__main__":
    main()
