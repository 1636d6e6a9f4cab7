"""A/B of the SAH BVH4 kernel's sources on the card (K8 nearest, K9
any-hit): ``csrc/bvh4.cu`` against other sources of its C interface, on
config 4's ray sets, in turns.

    git show <commit>:tpu_pathtracer_torch/csrc/bvh4.cu > <dir>/parent.cu
    python -m tpu_pathtracer_torch.experiments.bvh4_ab \\
        parent=<dir>/parent.cu [NAME=K:V,K:V ...] [--noleaf] [--out DIR]

``NAME=PATH`` adds a source (the first one given is the baseline of the
factors); ``NAME=K:V,...`` adds a variant of ``csrc/bvh4.cu`` with its
``constexpr int K`` set to V. ``new`` is ``csrc/bvh4.cu`` as it stands.
Each source is built with the package's nvcc flags (``ops/_build.py``),
its ptxas lines printed (and, with ``--out``, kept with its
``cuobjdump -sass``), and held bit-equal to the plain walk
(``ops/cuda_bvh4.py``: t, winners, occlusion, the five counters) on every
ray set before any is timed. Then each mode's call on each set is timed
in a CUDA graph (device time a call), the sources in turns, forward then
backward, ROUNDS rounds; the median is printed with its factor against
the baseline. ``--noleaf`` adds each source with its leaf loop cut, timed on
the primary rays with t_max at their hit t, where no slot passes, so the
walk is the full one without its leaves: the node walk's share. Last,
config 4's 2 spp frame through each source, which must be bit-equal.

Ray sets, 131,072 lanes each, on staircase-hires (config 4,
``bench.py:300-319``): ``chip_smoke.py`` phase 9's primary rays (pixels
across the frame), their bounce-2 rays and NEE shadow rays; the frame's
own shape, the contiguous middle-row pixels of one lane pool as primary
rays and their NEE rays; and the rays the engine hands each mode at the
regen iterations ITERS of a 1 spp frame (12: the pool full of paths at
mixed bounces, 25: the frame's tail, a third of the lanes live).
"""

from __future__ import annotations

import ctypes
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine import wavefront as wf
from tpu_pathtracer_torch.engine.regen import render_regen
from tpu_pathtracer_torch.experiments.common import (ab_sources, build,
                                                      card, first_bounce,
                                                      graph_ms, noleaf)
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh4 as cb4
from tpu_pathtracer_torch.ops.vec import FLT_MAX

CONFIG4 = dict(nx=1200, ny=800, ns=100, max_depth=64)
HIRES = dict(prims_per_leaf=64, sub=20)  # bench.py:305
RAYS = 131_072  # config 4's lane pool (engine/regen.py _pool_size)
ROUNDS = 7
ITERS = (12, 25)
# the leaf loops of csrc/bvh4.cu and of its first form (one thread a ray),
# and the same loops cut
LEAF_LOOPS = (("for (int k = s; k < width; k += L)",
               "for (int k = s; k < 0; k += L)"),
              ("k < width; ++k, row += 3", "k < 0; ++k, row += 3"))


def load(lib: Path) -> ctypes.CDLL:
    """The library, with ``bvh4_launch``'s signature set as
    ``cuda_bvh4._lib`` sets it."""
    dll = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    dll.bvh4_launch.argtypes = ([ctypes.c_int] + [p] * 10
                                + [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_int] + [p] * 6)
    dll.bvh4_launch.restype = ctypes.c_int
    return dll


def ray_sets(scene, cam, cfg, tabs, iters):
    """name: (any_hit, origin, direction, t_max [N]), each of RAYS lanes
    but the frame's iterations, and (primary rays, their plain walk)."""
    dev = cam.device
    view = wf.make_view(scene, cfg)
    plain = [(cb4, "bvh4_trace", cb4._bvh4_trace_ref),
             (cb4, "bvh4_occluded", cb4._bvh4_occluded_ref)]
    fmax = torch.full((RAYS,), FLT_MAX, device=dev)
    pix = torch.linspace(0, cfg.num_pixels - 1, RAYS,
                         device=dev).to(torch.int64)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    (o2, d2, t2), shadow = first_bounce(scene, view, cfg, o1, d1, pix, plain)
    lo = (cfg.num_pixels - RAYS) // 2
    pool = torch.arange(lo, lo + RAYS, device=dev)
    op, dp = cam.generate_rays(pool, 0, cfg.nx, cfg.ny)
    _, shadow_p = first_bounce(scene, view, cfg, op, dp, pool, plain)
    sets = {"primary": (False, o1, d1, fmax),
            "bounce-2": (False, o2, d2, t2), "NEE": (True, *shadow),
            "pool primary": (False, op, dp, fmax),
            "pool NEE": (True, *shadow_p)}
    # the rays of the frame's iterations, as the engine hands them over
    calls = {False: 0, True: 0}
    real = {False: cb4.bvh4_trace, True: cb4.bvh4_occluded}

    def catch(any_hit):
        def fn(o, d, t_max, tb, eps):
            calls[any_hit] += 1
            if calls[any_hit] in iters:
                tm = cb4._tmax_vector(t_max, o.x.shape[0], o.x)
                name = f"frame {'NEE' if any_hit else 'nearest'} " \
                       f"{calls[any_hit]}"
                sets[name] = (any_hit, type(o)(*(c.clone() for c in o)),
                              type(d)(*(c.clone() for c in d)), tm.clone())
            return real[any_hit](o, d, t_max, tb, eps)
        return fn

    with mock.patch.object(cb4, "bvh4_trace", catch(False)), \
            mock.patch.object(cb4, "bvh4_occluded", catch(True)):
        render_regen(scene, cam, cfg, ns=1)
    return sets, (o1, d1, cb4._bvh4_trace_ref(o1, d1, fmax, tabs,
                                              cfg.epsilon))


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = card("bvh4_ab")
    texts, cut, out = ab_sources(argv,
                                 (_build.CSRC_DIR / "bvh4.cu").read_text())
    if cut:
        texts.update({f"{k}_noleaf": noleaf(v, LEAF_LOOPS)
                      for k, v in list(texts.items())})
    with ThreadPoolExecutor(len(texts)) as ex:
        built = dict(zip(texts, ex.map(lambda kv: build(*kv, out),
                                       texts.items())))
    libs = {}
    for name, (lib, ptxas) in built.items():
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
        libs[name] = load(lib)

    cfg = RenderConfig(**CONFIG4)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny, device=dev,
                                            **HIRES)
    tabs = cb4.bvh4_tables(scene.mesh.bvh4)
    eps = cfg.epsilon
    sets, (o1, d1, (t_hit, i_hit, _)) = ray_sets(scene, cam, cfg, tabs,
                                                 ITERS)
    sets["primary at hit t"] = (False, o1, d1, torch.where(
        i_hit >= 0, t_hit, FLT_MAX).contiguous())
    ref = {}
    for sname, (any_hit, o, d, tm) in sets.items():
        walk = cb4._bvh4_occluded_ref if any_hit else cb4._bvh4_trace_ref
        ref[sname] = walk(o, d, tm, tabs, eps)
        c = ref[sname][-1].sum(1, dtype=torch.int64).tolist()
        print(f"[set] {sname}: {o.x.shape[0]} lanes, "
              f"{int((tm > 0).sum())} live, counters (both, single, "
              f"leaves, leaf_pop, steps) {c}", flush=True)

    def call(name, sname):
        any_hit, o, d, tm = sets[sname]
        with mock.patch.object(cb4, "_lib", lambda: libs[name]):
            fn = cb4.bvh4_occluded if any_hit else cb4.bvh4_trace
            return fn(o, d, tm, tabs, eps)

    def runs(name):
        """The sets a source is timed on: a cut one only at the hit t."""
        cut_one = name.endswith("_noleaf")
        return [s for s in sets if (s == "primary at hit t") or not cut_one]

    for name in libs:
        for sname in runs(name):
            tabs.overflow.zero_()
            got = call(name, sname)
            torch.cuda.synchronize()
            cb4.check_stack(tabs)
            for a, b in zip(got, ref[sname]):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"walk on {sname}")
        print(f"[check] {name}: bit-equal to the plain walk on "
              f"{len(runs(name))} sets", flush=True)

    times = {}
    order = list(libs)
    for r in range(ROUNDS):
        for name in order if r % 2 == 0 else order[::-1]:
            for sname in runs(name):
                times.setdefault((name, sname), []).append(
                    graph_ms(lambda: call(name, sname)))
    base = order[0]
    for sname in sets:
        cells = []
        for name in order:
            if (name, sname) in times:
                ms = statistics.median(times[name, sname])
                b = times.get((base, sname))
                factor = f" ({statistics.median(b) / ms:.2f}x)" if b else ""
                cells.append(f"{name} {ms:.4f}{factor}")
        print(f"[time] {sname}, ms a call in a CUDA graph, median of "
              f"{ROUNDS}: " + "; ".join(cells), flush=True)

    imgs = {}
    for name in (n for n in order if not n.endswith("_noleaf")):
        with mock.patch.object(cb4, "_lib", lambda: libs[name]):
            t0 = time.perf_counter()
            imgs[name] = render_regen(scene, cam, cfg, ns=2).cpu().numpy()
            print(f"[frame] {name}: config 4 at 2 spp in "
                  f"{time.perf_counter() - t0:.2f} s, mean "
                  f"{imgs[name].mean():.6f}", flush=True)
    first = next(iter(imgs.values()))
    same = all(np.array_equal(first, img) for img in imgs.values())
    print(f"[frame] the 2 spp images bit-equal: {same}", flush=True)
    if not same:
        raise AssertionError("the sources' 2 spp images differ")


if __name__ == "__main__":
    main()
