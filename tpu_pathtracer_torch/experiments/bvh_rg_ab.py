"""A/B of the regrouped heap kernel's sources on the card (K11 nearest,
``config.regroup``): ``csrc/bvh_rg.cu`` against other sources, on the
dragon-class knot's ray sets, in turns with each other and with K5.

    git show <commit>:tpu_pathtracer_torch/csrc/bvh_rg.cu > <dir>/parent.cu
    python -m tpu_pathtracer_torch.experiments.bvh_rg_ab \\
        parent=<dir>/parent.cu [NAME=K:V,K:V ...] [--noleaf] [--out DIR]

``NAME=PATH`` adds a source (the first one given is the baseline of the
factors); ``NAME=K:V,...`` adds a variant of ``csrc/bvh_rg.cu`` with its
``constexpr int K`` set to V. ``new`` is ``csrc/bvh_rg.cu`` as it stands.
Each source is driven through its own C entry ``bvh_rg_launch``, built
with the package's nvcc flags (``ops/_build.py``), its ptxas lines
printed (and, with ``--out``, kept with its ``cuobjdump -sass``). Before
any is timed, every source is held on every ray set bit-equal to the
plain walk (``ops/cuda_bvh_rg.py`` ``_rg_walk_ref``: t, winners, the five
counters), and its leaf visits within [1, 1.5]x the heap walk's. Then
each source's call on each set is timed in a CUDA graph (device time a
call), the sources and K5 (``cuda_bvh.heap_trace``, exact: the yardstick
the regroup knob stands beside) in turns, forward then backward, ROUNDS
rounds; the median is printed with its factor against the baseline.
Each set also prints the share of its recorded (ray, leaf) pairs whose
leaf another pair of the same warp's rays records in the same window
round, and of the same 2 neighbouring rays: the most a warp's leaf
phase could share rows, and what a batch of 2 windows could.
``--noleaf`` adds each source with its leaf loop cut, timed on the
primary rays with t_max at their hit t, where no slot passes, so the
walk is the full one without its leaf tests: the node walk's share.
Last, the 4 spp regroup dragon frame through each source, in turns
(seconds by CUDA events); the images must be bit-equal.

Ray sets on the dragon-class knot (``knot_zoo_scene(512, 512, nu=1664,
nv=262)``, 872k triangles, 64 a leaf): ``chip_smoke.py`` phase 10's
131,072 primary rays (pixels across the frame) and their bounce-2 rays;
the frame's own shape, the pool's 196,608 contiguous middle-row pixels
(``engine/regen.py``: the untextured packet path) as primary rays; and
the rays the engine hands ``rg_trace`` at two regen iterations of a 1 spp
regroup frame: FULL (the pool full of paths at mixed bounces) and the
tail's (the last iteration with at least TAIL_LIVE of the pool's lanes
live).
"""

from __future__ import annotations

import ctypes
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine import wavefront as wf
from tpu_pathtracer_torch.engine.regen import render_regen
from tpu_pathtracer_torch.experiments.common import (WARP, ab_sources, build,
                                                      card, event_ms,
                                                      first_bounce,
                                                      graph_ms, noleaf)
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh_rg as crg
from tpu_pathtracer_torch.ops.vec import FLT_MAX

DRAGON = dict(nx=512, ny=512, ns=4, max_depth=50, textures=False,
              regroup=True)
DRAGON_MESH = dict(nu=1664, nv=262)  # main.py:47
RAYS = 131_072   # chip_smoke.py phase 10's sets
POOL = 3 << 16   # the dragon frame's lane pool (engine/regen.py)
ROUNDS = 5
FULL = 2         # the regen iteration (from 1) of the pool full of paths
TAIL_LIVE = 0.1  # the tail set: the last iteration with this live share
FRAMES = 2       # rounds of the 4 spp frame through each source
K5 = "K5"        # the heap kernel's name among the timed calls
# the leaf loops of the split form and of the first form's staged flush,
# and the same loops cut
RG_LEAF_LOOPS = (("for (int k = s; k < P; k += L)",
                  "for (int k = s; k < 0; k += L)"),
                 ("for (int it = tid; it < items; it += kThreads)",
                  "for (int it = tid; it < 0; it += kThreads)"))


def load(lib: Path) -> ctypes.CDLL:
    """The library, with ``bvh_rg_launch``'s signature set as
    ``cuda_bvh_rg._lib`` sets it."""
    dll = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.bvh_rg_launch.argtypes = [p] * 9 + [i, i, f, i] + [p] * 4
    dll.bvh_rg_launch.restype = ctypes.c_int
    return dll


def launch(dll: ctypes.CDLL, origin, direction, tmax, tabs: cb.HeapTables,
           t_min: float):
    """``cuda_bvh_rg._launch`` through ``dll``'s C entry. Returns (t, tri,
    counters)."""
    n = origin.x.shape[0]
    dev = origin.x.device
    cnt = torch.empty((5, n), dtype=torch.int32, device=dev)
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    tri_out = torch.empty((n,), dtype=torch.int32, device=dev)
    rc = dll.bvh_rg_launch(
        *(a.data_ptr() for a in (*origin, *direction, tmax)),
        tabs.nodes.data_ptr(), tabs.tri.data_ptr(), tabs.first_leaf,
        tabs.prims_per_leaf, float(t_min), n, t_out.data_ptr(),
        tri_out.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bvh_rg_launch failed: CUDA error {rc}")
    return t_out, tri_out, cnt


def ray_sets(scene, cam, cfg):
    """name: (origin, direction, t_max): phase 10's sets, the pool's, and
    the frame's at iteration FULL and in its tail."""
    dev = cam.device
    view = wf.make_view(scene, cfg)
    fmax = lambda n: torch.full((n,), FLT_MAX, device=dev)
    pix = torch.linspace(0, cfg.num_pixels - 1, RAYS,
                         device=dev).to(torch.int64)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    (o2, d2, t2), _ = first_bounce(scene, view, cfg, o1, d1, pix, [])
    lo = (cfg.num_pixels - POOL) // 2
    op, dp = cam.generate_rays(torch.arange(lo, lo + POOL, device=dev), 0,
                               cfg.nx, cfg.ny)
    sets = {"primary": (o1, d1, fmax(RAYS)), "bounce-2": (o2, d2, t2),
            "pool primary": (op, dp, fmax(POOL))}
    # the rays of the frame's iterations, as the engine hands them over
    seen, real = [], crg.rg_trace

    def catch(o, d, t_max, tabs, eps):
        tm = cb._tmax_vector(t_max, o.x.shape[0], o.x)
        seen.append((type(o)(*(c.clone() for c in o)),
                     type(d)(*(c.clone() for c in d)), tm.clone()))
        return real(o, d, t_max, tabs, eps)

    with mock.patch.object(crg, "rg_trace", catch):
        render_regen(scene, cam, cfg, ns=1)
    live = [int((tm > 0).sum()) for _, _, tm in seen]
    print(f"[frame rays] live lanes a regen iteration {live}", flush=True)
    tail = max(k for k, x in enumerate(live) if x >= TAIL_LIVE * POOL)
    for k in (FULL - 1, tail):
        sets[f"frame {k + 1}"] = seen[k]
    return sets


def shared_leaf_share(windows, group: int = WARP) -> float:
    """The share of the recorded (ray, leaf) pairs whose leaf another
    pair of the same ``group`` neighbouring rays records in the same
    window round (``_rg_walk_ref``'s ``windows``)."""
    shared = total = 0
    for rays, leaves in windows:
        key = (rays // group) * (int(leaves.max()) + 1) + leaves
        _, inv, counts = torch.unique(key, return_inverse=True,
                                      return_counts=True)
        shared += int((counts[inv] > 1).sum())
        total += rays.numel()
    return shared / max(total, 1)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = card("bvh_rg_ab")
    texts, cut, out = ab_sources(argv,
                                 (_build.CSRC_DIR / "bvh_rg.cu").read_text())
    if cut:
        texts.update({f"{k}_noleaf": noleaf(v, RG_LEAF_LOOPS)
                      for k, v in list(texts.items())})
    with ThreadPoolExecutor(len(texts)) as ex:
        built = dict(zip(texts, ex.map(
            lambda kv: build(f"rg_{kv[0]}", kv[1], out), texts.items())))
    libs = {}
    for name, (lib, ptxas) in built.items():
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
        libs[name] = load(lib)

    cfg = RenderConfig(**DRAGON)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, device=dev, **DRAGON_MESH)
    if wf.mesh_tier(scene, cfg) != "heap-rg":
        raise AssertionError("the regroup dragon left the heap-rg route")
    tabs = cb.heap_tables(scene.mesh)
    eps = cfg.epsilon
    sets = ray_sets(scene, cam, cfg)
    order = list(libs)
    base = order[0]
    call = lambda name, sname: launch(libs[name], *sets[sname], tabs, eps)

    # t_max at the hit t: no slot passes
    o1, d1, _ = sets["primary"]
    t, tri, _ = call(base, "primary")
    sets["primary at hit t"] = (o1, d1, torch.where(tri >= 0, t,
                                                    FLT_MAX).contiguous())
    ref = {}
    for sname, (o, d, tm) in sets.items():
        windows = []
        ref[sname] = crg._rg_walk_ref(o, d, tm, tabs, eps, windows=windows)
        visits_k5 = int(cb.heap_trace(o, d, tm, tabs, eps)[2][2].sum())
        c = ref[sname][-1].sum(1, dtype=torch.int64).tolist()
        ratio = c[2] / max(visits_k5, 1)
        if not 1.0 <= ratio <= 1.5:
            raise AssertionError(f"{sname}: K11's leaf visits are "
                                 f"{ratio:.3f}x K5's, outside [1, 1.5]")
        print(f"[set] {sname}: {o.x.shape[0]} lanes, {int((tm > 0).sum())} "
              f"live, counters (both, single, leaves, 0, steps) {c}, "
              f"{len(windows)} window rounds; leaf visits {ratio:.3f}x "
              f"K5's; pairs sharing a leaf with another pair of the "
              f"round among the warp's rays {shared_leaf_share(windows):.2%}"
              f", among 2 neighbouring rays "
              f"{shared_leaf_share(windows, 2):.2%}", flush=True)

    def runs(name):
        """The sets a source is timed on; a cut source only the hit t's."""
        if name.endswith("_noleaf"):
            return ["primary at hit t"]
        return list(sets)

    for name in libs:
        for sname in runs(name):
            for a, b in zip(call(name, sname), ref[sname]):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"walk on {sname}")
        print(f"[check] {name}: bit-equal to the plain walk on "
              f"{len(runs(name))} sets", flush=True)

    timed = {**{n: partial(call, n) for n in order},
             K5: lambda sname: cb.heap_trace(*sets[sname], tabs, eps)}
    names = list(timed)
    times = {}
    for r in range(ROUNDS):
        for name in names if r % 2 == 0 else names[::-1]:
            for sname in runs(name):
                times.setdefault((name, sname), []).append(
                    graph_ms(lambda: timed[name](sname)))
    for sname in sets:
        b = times.get((base, sname))
        cells = []
        for name in names:
            if (name, sname) in times:
                ms = statistics.median(times[name, sname])
                factor = (f" ({statistics.median(b) / ms:.2f}x)" if b
                          else "")
                cells.append(f"{name} {ms:.4f}{factor}")
        print(f"[time] {sname}, ms a call in a CUDA graph, median of "
              f"{ROUNDS}: " + "; ".join(cells), flush=True)

    frames = [n for n in order if not n.endswith("_noleaf")]
    imgs, secs = {}, {}
    for r in range(FRAMES):
        for name in frames if r % 2 == 0 else frames[::-1]:
            with mock.patch.object(crg, "_launch", partial(launch,
                                                           libs[name])):
                render_regen(scene, cam, cfg, ns=1)  # warm-up
                holder = {}
                ms = event_ms(lambda: holder.update(
                    img=render_regen(scene, cam, cfg)))
            imgs.setdefault(name, holder["img"].cpu().numpy())
            secs.setdefault(name, []).append(ms / 1e3)
    for name in frames:
        print(f"[frame] {name}: the 4 spp regroup dragon frame in "
              + ", ".join(f"{s:.3f}" for s in secs[name])
              + f" s (CUDA events, in turns), mean {imgs[name].mean():.6f}",
              flush=True)
    first = next(iter(imgs.values()))
    same = all(np.array_equal(first, img) for img in imgs.values())
    print(f"[frame] the 4 spp regroup images bit-equal: {same}", flush=True)
    if not same:
        raise AssertionError("the sources' 4 spp regroup images differ")


if __name__ == "__main__":
    main()
