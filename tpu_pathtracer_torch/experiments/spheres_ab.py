"""A/B of the sphere kernel's sources on the card (K1 features, K1b t/idx,
K1c any-hit): ``csrc/spheres.cu`` against other sources of its C
interface, on the random-spheres headline's ray sets, in turns.

    git show <commit>:tpu_pathtracer_torch/csrc/spheres.cu > <dir>/parent.cu
    python -m tpu_pathtracer_torch.experiments.spheres_ab \\
        parent=<dir>/parent.cu [NAME=K:V,K:V ...] [--out DIR]

``NAME=PATH`` adds a source (the first one given is the baseline of the
factors); ``NAME=K:V,...`` adds a variant of ``csrc/spheres.cu`` with its
``constexpr int K`` set to V. ``new`` is ``csrc/spheres.cu`` as it stands.
A source whose C entry takes no ``tmax_all`` (the form before the float
t_max) is handed an [N] t_max wherever the wrapper passes a float, filled
as its wrapper filled it. Each source is built with the package's nvcc
flags (``ops/_build.py``), its ptxas lines printed (and, with ``--out``,
kept with its ``cuobjdump -sass``), and held bit-equal to the plain
version (t, idx, features, occlusion) on every ray set in all three modes
before any is timed. Then each mode's call on each set is timed in a CUDA
graph (device time a call), the sources in turns, forward then backward,
ROUNDS rounds; the median is printed with its factor against the
baseline. These calls pass the view's table and the [N] t_max, so every
source runs its kernel alone. Then the frame's own call on the pool's
primary rays, timed the same way: a source without ``tmax_all`` as its
wrapper made it (the table built and the [N] t_max filled on every call),
the others as the frame now makes it (the view's table, a float t_max).
Last, the headline at 2 spp through each source, forward then backward
(host seconds, the frame is host-bound), whose images must be bit-equal.

Ray sets on the random-spheres headline (BASELINE config 3, 1200x800,
486 spheres): the pool's shape, the 32,768 contiguous middle-row pixels
as primary rays (sample 0) and their second-bounce rays (t_max = -1 on
dead lanes); the frame's own, the rays the engine hands K1 at the regen
iterations ITERS of a 1 spp frame (40: the pool full of paths at mixed
bounces; 80: the frame's tail); and the 960,000 primary rays of the
frame. Any-hit takes each set with t_max just past the plain version's
hit on even lanes and at half of it on odd ones.
"""

from __future__ import annotations

import ctypes
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
                                                      graph_rounds,
                                                      sphere_pairs)
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

HEADLINE = dict(nx=1200, ny=800, ns=100, max_depth=50)
POOL = 1 << 15  # the headline's lane pool (engine/regen.py _pool_size)
ROUNDS = 7
ITERS = (40, 80)
MODES = ("features", "nearest", "any_hit")


def load(lib: Path, has_tmax_all: bool):
    """``spheres_hit_launch`` of the library, taking the current C entry's
    arguments (``cuda_spheres._launcher``'s); for a source without
    ``tmax_all`` a null t_max pointer becomes an [N] tensor of tmax_all."""
    fn = ctypes.CDLL(str(lib)).spheres_hit_launch
    p = ctypes.c_void_p
    tmax = [p, ctypes.c_float] if has_tmax_all else [p]
    fn.argtypes = ([ctypes.c_int] + [p] * 6 + tmax
                   + [p, ctypes.c_int, p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float] + [p] * 5)
    fn.restype = ctypes.c_int
    if has_tmax_all:
        return fn

    def vector(mode, ox, oy, oz, dx, dy, dz, tmax, tmax_all, *rest):
        n = rest[4]  # (sph, s, feat, n_c, n, ...)
        if tmax is None:
            filled = torch.full((n,), tmax_all, device="cuda")
            tmax = filled.data_ptr()
        # the fill and the launch are stream-ordered: freeing ``filled``
        # after the launch is safe
        return fn(mode, ox, oy, oz, dx, dy, dz, tmax, *rest)
    return vector


def ray_sets(scene, cam, cfg, view):
    """name: (origin, direction, t_max [N])."""
    dev = cam.device
    fmax = lambda n: torch.full((n,), FLT_MAX, device=dev)
    lo = (cfg.num_pixels - POOL) // 2
    pool = torch.arange(lo, lo + POOL, device=dev)
    op, dp = cam.generate_rays(pool, 0, cfg.nx, cfg.ny)
    plain = [(cs, "spheres_hit_feat",
              lambda *a, tab=None: cs._spheres_hit_feat_ref(*a))]
    bounce2, _ = first_bounce(scene, view, cfg, op, dp, pool, plain)
    sets = {"pool primary": (op, dp, fmax(POOL)), "pool bounce-2": bounce2}
    # the rays of the frame's iterations, as the engine hands them over
    calls = [0]
    real = cs.spheres_hit_feat

    def catch(o, d, c, r, feat, t_min, t_max, mx=False, *, tab=None):
        calls[0] += 1
        if calls[0] in ITERS:
            tm = cs._tmax_vector(t_max, o.x.shape[0], o.x)
            sets[f"frame iteration {calls[0]}"] = (
                V3(*(x.clone() for x in o)), V3(*(x.clone() for x in d)),
                tm.clone())
        return real(o, d, c, r, feat, t_min, t_max, mx, tab=tab)

    with mock.patch.object(cs, "spheres_hit_feat", catch):
        render_regen(scene, cam, cfg, ns=1)
    print(f"[set] a 1 spp frame: {calls[0]} regen iterations", flush=True)
    pix = torch.arange(cfg.num_pixels, device=dev)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    sets["primary 960,000"] = (o1, d1, fmax(cfg.num_pixels))
    return sets


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = card("spheres_ab")
    texts, _, out = ab_sources(argv,
                               (_build.CSRC_DIR / "spheres.cu").read_text())
    with ThreadPoolExecutor(len(texts)) as ex:
        built = dict(zip(texts, ex.map(
            lambda kv: build(f"spheres_{kv[0]}", kv[1], out),
            texts.items())))
    fns, current = {}, {}
    for name, (lib, ptxas) in built.items():
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
        current[name] = "float tmax_all" in texts[name]
        fns[name] = load(lib, current[name])

    cfg = RenderConfig(**HEADLINE)
    scene, cam = random_spheres_scene(cfg.nx, cfg.ny, device=dev)
    view = wf.make_view(scene, cfg)
    sph = (view.sph_c, view.sph_r)
    eps = cfg.epsilon
    sets = ray_sets(scene, cam, cfg, view)
    ref, tm_any = {}, {}
    for sname, (o, d, tm) in sets.items():
        t, idx, f = cs._spheres_hit_feat_ref(o, d, *sph, view.sph_feat, eps,
                                             tm)
        odd = torch.arange(t.numel(), device=dev) % 2 == 1
        tm_any[sname] = torch.where(
            idx >= 0, t * torch.where(odd, 0.5, 1.001), tm).contiguous()
        occ = cs._spheres_anyhit_ref(o, d, *sph, eps, tm_any[sname])
        ref[sname] = (t, idx, torch.stack(f), occ)
        pairs, disc = sphere_pairs(o, d, view.sph_tab, eps, tm)
        print(f"[set] {sname}: {o.x.shape[0]} lanes, {int((tm > eps).sum())} "
              f"live, {int((idx >= 0).sum())} hits, {pairs} pairs, {disc} "
              f"with disc > 0; any-hit {int(occ.sum())} occluded",
              flush=True)

    def call(name, sname, mode, frame=False):
        """One call of ``mode`` through the wrapper on source ``name``;
        ``frame``: the frame's own call (float t_max; the view's table
        where the source takes it)."""
        o, d, tm = sets[sname]
        with mock.patch.object(cs, "_launcher",
                               lambda mx=False: fns[name]):
            if frame:
                tab = view.sph_tab if current[name] else None
                return cs.spheres_hit_feat(o, d, *sph, view.sph_feat, eps,
                                           FLT_MAX, tab=tab)
            if mode == "features":
                return cs.spheres_hit_feat(o, d, *sph, view.sph_feat, eps,
                                           tm, tab=view.sph_tab)
            if mode == "nearest":
                return cs.spheres_hit_soa(o, d, *sph, eps, tm,
                                          tab=view.sph_tab)
            return cs.spheres_anyhit_soa(o, d, *sph, eps, tm_any[sname],
                                         tab=view.sph_tab)

    for name in fns:
        for sname in sets:
            t, idx, f, occ = ref[sname]
            tk, ik, fk = call(name, sname, "features")
            t2, i2 = call(name, sname, "nearest")
            ok = call(name, sname, "any_hit")
            torch.cuda.synchronize()
            same = (torch.equal(tk, t) and torch.equal(ik, idx)
                    and torch.equal(torch.stack(fk), f)
                    and torch.equal(t2, t) and torch.equal(i2, idx)
                    and torch.equal(ok, occ))
            if not same:
                raise AssertionError(f"{name} differs from the plain "
                                     f"version on {sname}")
        print(f"[check] {name}: bit-equal to the plain version on "
              f"{len(sets)} sets in all three modes", flush=True)

    order = list(fns)
    cells = [(s, m) for s in sets for m in MODES] + [("pool primary",
                                                      "frame's call")]
    times = graph_rounds(
        order, cells, lambda name, cell: call(
            name, *cell, frame=cell[1] == "frame's call"), ROUNDS)
    for cell in cells:
        b = times[order[0], cell]
        row = [f"{name} {times[name, cell]:.4f} "
               f"({b / times[name, cell]:.2f}x)" for name in order]
        print(f"[time] {cell[0]} {cell[1]}, ms a call in a CUDA graph, "
              f"median of {ROUNDS}: " + "; ".join(row), flush=True)

    imgs, secs = {}, {name: [] for name in order}
    for name in order + order[::-1]:
        with mock.patch.object(cs, "_launcher", lambda mx=False: fns[name]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs[name] = render_regen(scene, cam, cfg, ns=2).cpu().numpy()
            secs[name].append(time.perf_counter() - t0)
    for name in order:
        print(f"[frame] {name}: the headline at 2 spp in "
              + ", ".join(f"{t:.3f}" for t in secs[name])
              + f" s (in turns), mean {imgs[name].mean():.6f}", flush=True)
    first = next(iter(imgs.values()))
    same = all(np.array_equal(first, img) for img in imgs.values())
    print(f"[frame] the 2 spp images bit-equal: {same}", flush=True)
    if not same:
        raise AssertionError("the sources' 2 spp images differ")


if __name__ == "__main__":
    main()
