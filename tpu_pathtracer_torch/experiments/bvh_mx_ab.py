"""A/B of the MXU-leaf heap kernel's sources on the card (K10 nearest,
K10b any-hit): ``csrc/bvh_mx.cu`` against other sources, on the
dragon-class knot's ray sets at 3 and 6 passes, in turns.

    git show <commit>:tpu_pathtracer_torch/csrc/bvh_mx.cu > <dir>/parent.cu
    python -m tpu_pathtracer_torch.experiments.bvh_mx_ab \\
        parent=<dir>/parent.cu [NAME=K:V,K:V ...] [--noleaf] [--out DIR]

``NAME=PATH`` adds a source (the first one given is the baseline of the
factors); ``NAME=K:V,...`` adds a variant of ``csrc/bvh_mx.cu`` with its
``constexpr int K`` set to V. ``new`` is ``csrc/bvh_mx.cu`` as it stands.
Each source is driven through its own C entry ``bvh_mx_launch``: a
source that exports ``bvh_mx_part_columns`` reads G's bf16 parts
(``MxTables.parts``), the first form G's f32 rows (``MxTables.g``).
Each is built with the package's nvcc flags (``ops/_build.py``), its
ptxas lines printed (and, with ``--out``, kept with its
``cuobjdump -sass``), and held bit-equal to the plain walk
(``ops/cuda_bvh_mx.py``: t, winners, occlusion, the five counters) on
every ray set at both pass counts before any is timed. Then each mode's
call on each set at each pass count is timed in a CUDA graph (device
time a call), the sources in turns, forward then backward, ROUNDS rounds;
the median is printed with its factor against the baseline. ``--noleaf``
adds each source with its nearest leaf loop cut, timed on the primary
rays with t_max at their hit t, where no slot passes, so the walk is the
full one without its leaves: the node walk's share. Last, the 4 spp
``mx_leaf`` dragon frame through each source, forward then backward
(seconds by CUDA events), whose images must be bit-equal.

Ray sets on the dragon-class knot (``knot_zoo_scene(512, 512, nu=1664,
nv=262)``, 872k triangles, 64 a leaf): ``chip_smoke.py`` phase 10's
131,072 primary rays (pixels across the frame), their bounce-2 rays and
NEE shadow rays; the frame's own shape, the pool's 196,608 contiguous
middle-row pixels (``engine/regen.py``: the untextured packet path) as
primary rays and their NEE rays; and the rays the engine hands each mode
at two regen iterations of a 1 spp ``mx_leaf`` frame: FULL (the pool full
of paths at mixed bounces) and the tail's (the last iteration with at
least TAIL_LIVE of the pool's lanes live). ``primary at hit t`` takes
each pass count's own hit t.
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
from tpu_pathtracer_torch.experiments.common import (ab_sources, build,
                                                      card, event_ms,
                                                      first_bounce,
                                                      graph_ms, noleaf)
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh_mx as cmx
from tpu_pathtracer_torch.ops.vec import FLT_MAX

DRAGON = dict(nx=512, ny=512, ns=4, max_depth=50, textures=False,
              mx_leaf=True)
DRAGON_MESH = dict(nu=1664, nv=262)  # main.py:47
RAYS = 131_072   # chip_smoke.py phase 10's sets
POOL = 3 << 16   # the dragon frame's lane pool (engine/regen.py)
ROUNDS = 5
FULL = 2         # the regen iteration (from 1) of the pool full of paths
TAIL_LIVE = 0.1  # the tail set: the last iteration with this live share
FRAMES = 2       # rounds of the 4 spp frame through each source


def load(lib: Path) -> ctypes.CDLL:
    """The library, with ``bvh_mx_launch``'s signature set as
    ``cuda_bvh_mx._lib`` sets it."""
    dll = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.bvh_mx_launch.argtypes = ([i, i] + [p] * 9 + [i, i, f, f, f, f, i]
                                  + [p] * 5)
    dll.bvh_mx_launch.restype = ctypes.c_int
    return dll


def launch(dll: ctypes.CDLL, mode: int, origin, direction, tmax,
           tabs: cmx.MxTables, t_min: float, passes: int):
    """``cuda_bvh_mx._launch`` through ``dll``'s C entry: G's bf16 parts
    for a source that exports ``bvh_mx_part_columns``, G's f32 rows for
    the first form. Returns what ``_launch`` returns."""
    n = origin.x.shape[0]
    dev = origin.x.device
    g = tabs.parts if hasattr(dll, "bvh_mx_part_columns") else tabs.g
    cnt = torch.empty((5, n), dtype=torch.int32, device=dev)
    t_out = tri_out = occ_out = None
    if mode == cmx._ANY_HIT:
        occ_out = torch.empty((n,), dtype=torch.bool, device=dev)
    else:
        t_out = torch.empty((n,), dtype=torch.float32, device=dev)
        tri_out = torch.empty((n,), dtype=torch.int32, device=dev)
    ptr = lambda a: None if a is None else a.data_ptr()
    heap = tabs.heap
    rc = dll.bvh_mx_launch(
        mode, passes, *(a.data_ptr() for a in (*origin, *direction, tmax)),
        heap.nodes.data_ptr(), g.data_ptr(), heap.first_leaf,
        heap.prims_per_leaf, *tabs.center_xyz, float(t_min), n, ptr(t_out),
        ptr(tri_out), ptr(occ_out), cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bvh_mx_launch failed: CUDA error {rc}")
    return t_out, tri_out, occ_out, cnt


def outputs(any_hit: bool, got):
    """The mode's outputs of a launch: (t, tri, counters) or (occ,
    counters), as the plain walks return them."""
    t, tri, occ, cnt = got
    return (occ, cnt) if any_hit else (t, tri, cnt)


def ray_sets(scene, cam, cfg, tabs):
    """name: (any_hit, origin, direction, t_max [N] or {passes: [N]}):
    phase 10's sets, the pool's, the frame's at iteration FULL and in its
    tail, and the primary rays at each pass count's hit t."""
    dev = cam.device
    base = cfg.replace(mx_leaf=False)  # phase 10's rays: K5 and K6
    view = wf.make_view(scene, base)
    fmax = lambda n: torch.full((n,), FLT_MAX, device=dev)
    pix = torch.linspace(0, cfg.num_pixels - 1, RAYS,
                         device=dev).to(torch.int64)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    (o2, d2, t2), shadow = first_bounce(scene, view, base, o1, d1, pix, [])
    lo = (cfg.num_pixels - POOL) // 2
    pool = torch.arange(lo, lo + POOL, device=dev)
    op, dp = cam.generate_rays(pool, 0, cfg.nx, cfg.ny)
    _, shadow_p = first_bounce(scene, view, base, op, dp, pool, [])
    sets = {"primary": (False, o1, d1, fmax(RAYS)),
            "bounce-2": (False, o2, d2, t2), "NEE": (True, *shadow),
            "pool primary": (False, op, dp, fmax(POOL)),
            "pool NEE": (True, *shadow_p)}
    # the rays of the frame's iterations, as the engine hands them over
    seen = {False: [], True: []}
    real = {False: cmx.mx_trace, True: cmx.mx_occluded}

    def catch(any_hit):
        def fn(o, d, t_max, tb, eps, passes):
            tm = cmx._tmax_vector(t_max, o.x.shape[0], o.x)
            seen[any_hit].append((type(o)(*(c.clone() for c in o)),
                                  type(d)(*(c.clone() for c in d)),
                                  tm.clone()))
            return real[any_hit](o, d, t_max, tb, eps, passes)
        return fn

    with mock.patch.object(cmx, "mx_trace", catch(False)), \
            mock.patch.object(cmx, "mx_occluded", catch(True)):
        render_regen(scene, cam, cfg, ns=1)
    for any_hit, calls in seen.items():
        live = [int((tm > 0).sum()) for _, _, tm in calls]
        print(f"[frame rays] {'NEE' if any_hit else 'nearest'}: live lanes "
              f"a regen iteration {live}", flush=True)
        tail = max(k for k, x in enumerate(live) if x >= TAIL_LIVE * POOL)
        for k in (FULL - 1, tail):
            sets[f"frame {'NEE' if any_hit else 'nearest'} {k + 1}"] = (
                any_hit, *calls[k])
    # t_max at each pass count's own hit t: no slot passes
    hit_t = {}
    for passes in cmx.PASSES:
        t, tri, _ = cmx._mx_trace_ref(o1, d1, fmax(RAYS), tabs, cfg.epsilon,
                                      passes)
        hit_t[passes] = torch.where(tri >= 0, t, FLT_MAX).contiguous()
    sets["primary at hit t"] = (False, o1, d1, hit_t)
    return sets


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = card("bvh_mx_ab")
    texts, cut, out = ab_sources(
        argv, (_build.CSRC_DIR / "bvh_mx.cu").read_text())
    if cut:
        texts.update({f"{k}_noleaf": noleaf(v) for k, v in list(
            texts.items())})
    with ThreadPoolExecutor(len(texts)) as ex:
        built = dict(zip(texts, ex.map(lambda kv: build(*kv, out),
                                       texts.items())))
    libs = {}
    for name, (lib, ptxas) in built.items():
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
        libs[name] = load(lib)

    cfg = RenderConfig(**DRAGON)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, device=dev, **DRAGON_MESH)
    tabs = cmx.mx_tables(scene.mesh)
    eps = cfg.epsilon
    sets = ray_sets(scene, cam, cfg, tabs)
    t_max = lambda sname, passes: (sets[sname][3][passes]
                                   if isinstance(sets[sname][3], dict)
                                   else sets[sname][3])
    ref = {}
    for sname, (any_hit, o, d, _) in sets.items():
        walk = cmx._mx_occluded_ref if any_hit else cmx._mx_trace_ref
        for passes in cmx.PASSES:
            tm = t_max(sname, passes)
            ref[sname, passes] = walk(o, d, tm, tabs, eps, passes)
            c = ref[sname, passes][-1].sum(1, dtype=torch.int64).tolist()
            print(f"[set] {sname} at {passes} passes: {o.x.shape[0]} "
                  f"lanes, {int((tm > 0).sum())} live, counters (both, "
                  f"single, leaves, 0, steps) {c}", flush=True)

    def call(name, sname, passes):
        any_hit, o, d, _ = sets[sname]
        mode = cmx._ANY_HIT if any_hit else cmx._NEAREST
        return outputs(any_hit, launch(libs[name], mode, o, d,
                                       t_max(sname, passes), tabs, eps,
                                       passes))

    def runs(name):
        """The sets a source is timed on: a cut one only at the hit t."""
        cut_one = name.endswith("_noleaf")
        return [s for s in sets if (s == "primary at hit t") or not cut_one]

    for name in libs:
        for sname in runs(name):
            for passes in cmx.PASSES:
                got = call(name, sname, passes)
                for a, b in zip(got, ref[sname, passes]):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"{name} differs from the plain walk on "
                            f"{sname} at {passes} passes")
        print(f"[check] {name}: bit-equal to the plain walk on "
              f"{len(runs(name))} sets at 3 and 6 passes", flush=True)

    times = {}
    order = list(libs)
    for r in range(ROUNDS):
        for name in order if r % 2 == 0 else order[::-1]:
            for sname in runs(name):
                for passes in cmx.PASSES:
                    times.setdefault((name, sname, passes), []).append(
                        graph_ms(lambda: call(name, sname, passes)))
    base = order[0]
    for sname in sets:
        for passes in cmx.PASSES:
            cells = []
            for name in order:
                if (name, sname, passes) in times:
                    ms = statistics.median(times[name, sname, passes])
                    b = times.get((base, sname, passes))
                    factor = (f" ({statistics.median(b) / ms:.2f}x)" if b
                              else "")
                    cells.append(f"{name} {ms:.4f}{factor}")
            print(f"[time] {sname} at {passes} passes, ms a call in a CUDA "
                  f"graph, median of {ROUNDS}: " + "; ".join(cells),
                  flush=True)

    imgs, secs = {}, {}
    frames = [n for n in order if not n.endswith("_noleaf")]
    for r in range(FRAMES):
        for name in frames if r % 2 == 0 else frames[::-1]:
            with mock.patch.object(cmx, "_launch", partial(launch,
                                                           libs[name])):
                render_regen(scene, cam, cfg, ns=1)  # warm-up
                holder = {}
                ms = event_ms(lambda: holder.update(
                    img=render_regen(scene, cam, cfg)))
            imgs.setdefault(name, holder["img"].cpu().numpy())
            secs.setdefault(name, []).append(ms / 1e3)
    for name in frames:
        print(f"[frame] {name}: the 4 spp mx_leaf dragon frame in "
              + ", ".join(f"{s:.3f}" for s in secs[name])
              + f" s (CUDA events, in turns), mean {imgs[name].mean():.6f}",
              flush=True)
    first = next(iter(imgs.values()))
    same = all(np.array_equal(first, img) for img in imgs.values())
    print(f"[frame] the 4 spp images bit-equal: {same}", flush=True)
    if not same:
        raise AssertionError("the sources' 4 spp images differ")


if __name__ == "__main__":
    main()
