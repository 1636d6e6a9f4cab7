"""A/B of the heap BVH kernel's sources on the card (K5 nearest, K6
any-hit): ``csrc/bvh.cu`` against other sources, on the dragon-class
knot's ray sets in the exact and fast_math modes, in turns.

    git show <commit>:tpu_pathtracer_torch/csrc/bvh.cu > <dir>/parent.cu
    python -m tpu_pathtracer_torch.experiments.bvh_ab \\
        parent=<dir>/parent.cu [NAME=K:V,K:V ...] [--noleaf] [--out DIR]

``NAME=PATH`` adds a source (the first one given is the baseline of the
factors and the reference of the fast_math mode); ``NAME=K:V,...`` adds a
variant of ``csrc/bvh.cu`` with its ``constexpr int K`` set to V. ``new``
is ``csrc/bvh.cu`` as it stands. Each source is driven through its own C
entry ``bvh_heap_launch``, built with the package's nvcc flags
(``ops/_build.py``), its ptxas lines printed (and, with ``--out``, kept
with its ``cuobjdump -sass``). Before any is timed, every source is held
on every ray set bit-equal to the plain walk (``ops/cuda_bvh.py``: t,
winners, occlusion, the five counters) in the exact mode, and bit-equal
to the baseline's outputs in the fast_math mode (the plain walk keeps
the exact division there). Then each mode's call on each set is timed in
a CUDA graph (device time a call), the sources in turns, forward then
backward, ROUNDS rounds; the median is printed with its factor against
the baseline. ``--noleaf`` adds each source with its nearest leaf loop
cut, timed on the primary rays with t_max at their hit t (each mode's
own), where no slot passes, so the walk is the full one without its
leaves: the node walk's share. Last, the 4 spp default, fast_math and
regroup dragon frames through each source, in turns (seconds by CUDA
events); each frame's images must be bit-equal across the sources.

Ray sets on the dragon-class knot (``knot_zoo_scene(512, 512, nu=1664,
nv=262)``, 872k triangles, 64 a leaf): ``chip_smoke.py`` phase 10's
131,072 primary rays (pixels across the frame), their bounce-2 rays and
NEE shadow rays; the frame's own shape, the pool's 196,608 contiguous
middle-row pixels (``engine/regen.py``: the untextured packet path) as
primary rays and their NEE rays; and the rays the engine hands each mode
at two regen iterations of a 1 spp default frame: FULL (the pool full
of paths at mixed bounces) and the tail's (the last iteration with at
least TAIL_LIVE of the pool's lanes live).
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
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops.vec import FLT_MAX

DRAGON = dict(nx=512, ny=512, ns=4, max_depth=50, textures=False)
DRAGON_MESH = dict(nu=1664, nv=262)  # main.py:47
RAYS = 131_072   # chip_smoke.py phase 10's sets
POOL = 3 << 16   # the dragon frame's lane pool (engine/regen.py)
ROUNDS = 5
FULL = 2         # the regen iteration (from 1) of the pool full of paths
TAIL_LIVE = 0.1  # the tail set: the last iteration with this live share
FRAMES = 2       # rounds of each 4 spp frame through each source
MODES = {"exact": False, "fast_math": True}  # approx_recip
KNOBS = {"default": {}, "fast_math": dict(fast_math=True),
         "regroup": dict(regroup=True)}


def load(lib: Path) -> ctypes.CDLL:
    """The library, with ``bvh_heap_launch``'s signature set as
    ``cuda_bvh._lib`` sets it."""
    dll = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.bvh_heap_launch.argtypes = [i, i] + [p] * 9 + [i, i, f, i] + [p] * 5
    dll.bvh_heap_launch.restype = ctypes.c_int
    return dll


def launch(dll: ctypes.CDLL, mode: int, origin, direction, tmax,
           tabs: cb.HeapTables, t_min: float, approx_recip: bool = False):
    """``cuda_bvh._launch`` through ``dll``'s C entry. Returns what
    ``_launch`` returns."""
    n = origin.x.shape[0]
    dev = origin.x.device
    cnt = torch.empty((5, n), dtype=torch.int32, device=dev)
    t_out = tri_out = occ_out = None
    if mode == cb._ANY_HIT:
        occ_out = torch.empty((n,), dtype=torch.bool, device=dev)
    else:
        t_out = torch.empty((n,), dtype=torch.float32, device=dev)
        tri_out = torch.empty((n,), dtype=torch.int32, device=dev)
    ptr = lambda a: None if a is None else a.data_ptr()
    rc = dll.bvh_heap_launch(
        mode, int(approx_recip),
        *(a.data_ptr() for a in (*origin, *direction, tmax)),
        tabs.nodes.data_ptr(), tabs.tri.data_ptr(), tabs.first_leaf,
        tabs.prims_per_leaf, float(t_min), n, ptr(t_out), ptr(tri_out),
        ptr(occ_out), cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bvh_heap_launch failed: CUDA error {rc}")
    return t_out, tri_out, occ_out, cnt


def outputs(any_hit: bool, got):
    """The mode's outputs of a launch: (t, tri, counters) or (occ,
    counters), as the plain walks return them."""
    t, tri, occ, cnt = got
    return (occ, cnt) if any_hit else (t, tri, cnt)


def fixed_sets(scene, cam, cfg):
    """name: (any_hit, origin, direction, t_max): phase 10's sets and the
    pool's."""
    dev = cam.device
    view = wf.make_view(scene, cfg)
    fmax = lambda n: torch.full((n,), FLT_MAX, device=dev)
    pix = torch.linspace(0, cfg.num_pixels - 1, RAYS,
                         device=dev).to(torch.int64)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    (o2, d2, t2), shadow = first_bounce(scene, view, cfg, o1, d1, pix, [])
    lo = (cfg.num_pixels - POOL) // 2
    pool = torch.arange(lo, lo + POOL, device=dev)
    op, dp = cam.generate_rays(pool, 0, cfg.nx, cfg.ny)
    _, shadow_p = first_bounce(scene, view, cfg, op, dp, pool, [])
    sets = {"primary": (False, o1, d1, fmax(RAYS)),
            "bounce-2": (False, o2, d2, t2), "NEE": (True, *shadow),
            "pool primary": (False, op, dp, fmax(POOL)),
            "pool NEE": (True, *shadow_p)}
    return sets


def ray_sets(scene, cam, cfg):
    """name: (any_hit, origin, direction, t_max): phase 10's sets, the
    pool's, and the frame's at iteration FULL and in its tail."""
    sets = fixed_sets(scene, cam, cfg)
    # the rays of the frame's iterations, as the engine hands them over
    seen = {False: [], True: []}
    real = {False: cb.heap_trace, True: cb.heap_occluded}

    def catch(any_hit):
        def fn(o, d, t_max, tb, eps, approx_recip=False):
            tm = cb._tmax_vector(t_max, o.x.shape[0], o.x)
            seen[any_hit].append((type(o)(*(c.clone() for c in o)),
                                  type(d)(*(c.clone() for c in d)),
                                  tm.clone()))
            return real[any_hit](o, d, t_max, tb, eps,
                                 approx_recip=approx_recip)
        return fn

    with mock.patch.object(cb, "heap_trace", catch(False)), \
            mock.patch.object(cb, "heap_occluded", catch(True)):
        render_regen(scene, cam, cfg, ns=1)
    for any_hit, calls in seen.items():
        live = [int((tm > 0).sum()) for _, _, tm in calls]
        print(f"[frame rays] {'NEE' if any_hit else 'nearest'}: live lanes "
              f"a regen iteration {live}", flush=True)
        tail = max(k for k, x in enumerate(live) if x >= TAIL_LIVE * POOL)
        for k in (FULL - 1, tail):
            sets[f"frame {'NEE' if any_hit else 'nearest'} {k + 1}"] = (
                any_hit, *calls[k])
    return sets


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = card("bvh_ab")
    texts, cut, out = ab_sources(argv,
                                 (_build.CSRC_DIR / "bvh.cu").read_text())
    if cut:
        texts.update({f"{k}_noleaf": noleaf(v) for k, v in list(
            texts.items())})
    with ThreadPoolExecutor(len(texts)) as ex:
        built = dict(zip(texts, ex.map(
            lambda kv: build(f"heap_{kv[0]}", kv[1], out), texts.items())))
    libs = {}
    for name, (lib, ptxas) in built.items():
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
        libs[name] = load(lib)

    cfg = RenderConfig(**DRAGON)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, device=dev, **DRAGON_MESH)
    tabs = cb.heap_tables(scene.mesh)
    eps = cfg.epsilon
    sets = ray_sets(scene, cam, cfg)
    order = list(libs)
    base = order[0]

    def call(name, sname, mode):
        any_hit, o, d, tm = sets[sname]
        kind = cb._ANY_HIT if any_hit else cb._NEAREST
        return outputs(any_hit, launch(libs[name], kind, o, d, tm, tabs,
                                       eps, MODES[mode]))

    # t_max at each mode's own hit t: no slot passes
    o1, d1 = sets["primary"][1:3]
    for mode in MODES:
        t, tri, _ = call(base, "primary", mode)
        sets[f"primary at hit t, {mode}"] = (
            False, o1, d1, torch.where(tri >= 0, t, FLT_MAX).contiguous())
    ref = {}
    for sname, (any_hit, o, d, tm) in sets.items():
        walk = cb._heap_occluded_ref if any_hit else cb._heap_trace_ref
        ref[sname] = walk(o, d, tm, tabs, eps)
        c = ref[sname][-1].sum(1, dtype=torch.int64).tolist()
        print(f"[set] {sname}: {o.x.shape[0]} lanes, {int((tm > 0).sum())} "
              f"live, counters (both, single, leaves, 0, steps) {c}",
              flush=True)

    def runs(name):
        """(set, mode) a source is timed on: each set in each mode, the
        hit t's sets in their own mode; a cut source only those."""
        hit_t = [(f"primary at hit t, {m}", m) for m in MODES]
        if name.endswith("_noleaf"):
            return hit_t
        return [(s, m) for s in sets for m in MODES
                if not s.startswith("primary at hit t")] + hit_t

    fast_ref = {}  # the baseline's fast_math outputs: it is checked first
    for name in libs:
        for sname, mode in runs(name):
            got = call(name, sname, mode)
            if mode == "exact":
                want, what = ref[sname], "the plain walk"
            else:
                want = fast_ref.setdefault(sname, got)
                what = f"{base}'s fast_math outputs"
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} differs from {what} on "
                                         f"{sname} ({mode})")
        print(f"[check] {name}: exact bit-equal to the plain walk, "
              f"fast_math bit-equal to {base}'s, on "
              f"{len({s for s, _ in runs(name)})} sets", flush=True)

    times = {}
    for r in range(ROUNDS):
        for name in order if r % 2 == 0 else order[::-1]:
            for sname, mode in runs(name):
                times.setdefault((name, sname, mode), []).append(
                    graph_ms(lambda: call(name, sname, mode)))
    for sname in sets:
        for mode in MODES:
            cells = []
            for name in order:
                if (name, sname, mode) in times:
                    ms = statistics.median(times[name, sname, mode])
                    b = times.get((base, sname, mode))
                    factor = (f" ({statistics.median(b) / ms:.2f}x)" if b
                              else "")
                    cells.append(f"{name} {ms:.4f}{factor}")
            if cells:
                print(f"[time] {sname} ({mode}), ms a call in a CUDA graph, "
                      f"median of {ROUNDS}: " + "; ".join(cells), flush=True)

    frames = [n for n in order if not n.endswith("_noleaf")]
    for knob, kw in KNOBS.items():
        kcfg = cfg.replace(**kw)
        imgs, secs = {}, {}
        for r in range(FRAMES):
            for name in frames if r % 2 == 0 else frames[::-1]:
                with mock.patch.object(cb, "_launch", partial(launch,
                                                              libs[name])):
                    render_regen(scene, cam, kcfg, ns=1)  # warm-up
                    holder = {}
                    ms = event_ms(lambda: holder.update(
                        img=render_regen(scene, cam, kcfg)))
                imgs.setdefault(name, holder["img"].cpu().numpy())
                secs.setdefault(name, []).append(ms / 1e3)
        for name in frames:
            print(f"[frame] {name}: the 4 spp {knob} dragon frame in "
                  + ", ".join(f"{s:.3f}" for s in secs[name])
                  + f" s (CUDA events, in turns), mean "
                  f"{imgs[name].mean():.6f}", flush=True)
        first = next(iter(imgs.values()))
        same = all(np.array_equal(first, img) for img in imgs.values())
        print(f"[frame] the 4 spp {knob} images bit-equal: {same}",
              flush=True)
        if not same:
            raise AssertionError(f"the sources' 4 spp {knob} images differ")


if __name__ == "__main__":
    main()
