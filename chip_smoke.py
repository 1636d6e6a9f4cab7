"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's ported paths on the card through
``tpu_pathtracer_torch.engine.regen``: the random-spheres headline
(BASELINE config 3: 1200x800, 100 spp, max depth 50), the procedural
staircase (the staircase-toy row of bench.py: 1200x800, 100 spp, max
depth 64; triangle mesh, textures, NEE shadow rays), the asset-scale
staircase (BASELINE config 4, staircase-hires: 154k triangles, the SAH
BVH4 tier) and the dragon-class knot (872k triangles, the heap BVH
tier). It builds the CUDA kernels from ``tpu_pathtracer_torch/csrc``
first and holds each against its plain PyTorch version at the shapes its
path gives it. Phases, one line each; any failure raises and exits
non-zero:

  1. device: the nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc builds spheres.cu, tris.cu, bvh.cu and bvh4.cu side by
     side, g++ the native BVH builder (seconds, ptxas lines);
  3. spheres, kernel vs plain on the 960,000 primary rays of sample 0 and
     on the second-bounce rays, in all three modes; times (CUDA events,
     median of 7 warm runs);
  4. spheres end to end, small: 96x64, 4 spp, max depth 8, kernel vs
     plain: rmse < 5e-3, SSIM >= 0.99;
  5. spheres end to end, full size, through the kernel: seconds, Mpaths/s,
     and the 128x128 center crop against the committed TPU-rendered
     golden assets/bench_spheres_100spp.ref: rmse < 5e-3, SSIM >= 0.99;
  6. triangles, kernel vs plain at the staircase's shapes (primary,
     second-bounce and NEE shadow rays), all three modes;
  7. staircase end to end, small, kernel vs plain, as phase 4;
  8. staircase end to end, full size, as phase 5 against
     assets/bench_staircase_toy_100spp.ref;
  9. BVH4 (K8 nearest, K9 any-hit) vs plain on staircase-hires: 131,072
     primary rays from across the 1200x800 frame, the same lanes'
     second-bounce rays and their first bounce's NEE shadow rays (lanes
     without one at t_max = -1): t bit-equal, ids equal except exact
     ties, occlusion and per-ray counters equal; times as in phase 3; the
     distinct node rows and leaves the plain walk read (its bytes bound);
 10. heap BVH (K5, K6) vs plain on the dragon-class knot, in the same way;
 11. small: staircase-hires 96x64, 4 spp, depth 8, kernels vs plain, and
     with bvh4=False (through K5/K6) against the BVH4 render;
 12. config 4: staircase-hires 1200x800, 2 spp gated against
     assets/bench_staircase_hires_2spp.ref, then 100 spp depth 64 timed:
     seconds, Mpaths/s, regen iterations, launches of each kernel, mean;
 13. dragon: the 872k knot 512x512, 4 spp, depth 50, untextured, timed
     and gated against assets/bench_dragon_4spp.ref;
 14. profile: one sample per pixel of config 4's frame, over its middle
     rows, two lane pools' worth of pixels (the profiler's cost grows with
     the kernels it records), under torch.profiler: host dispatches and
     device kernel time per regen iteration, the device's busy share, the
     kernels that take most.

Each full-size run resets the launch counts just before it and reads
them just after. Every kernel's record carries its bound: the larger of
its FP32 operations (counted from the source and this run's inputs, for
the BVH kernels from the node steps and leaf slots its per-ray counters
report) over 67 TFLOP/s and its bytes (inputs read once, outputs written
once; of a BVH's tables only the distinct node rows and leaf triangle
rows this run's rays read) over 3.35 TB/s. The line before the last is the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``. Needs a CUDA
device: without one it exits non-zero and prints no result. Imports
nothing of JAX.
"""

import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from tpu_pathtracer_torch import native
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine import wavefront as wf
from tpu_pathtracer_torch.engine.regen import (_pool_size,
                                               render_image_regen,
                                               render_regen)
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh4 as cb4
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops import cuda_tris as ct
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX
from tpu_pathtracer_torch.utils import golden

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(nx=1200, ny=800, ns=100, max_depth=50)
STAIRCASE = dict(nx=1200, ny=800, ns=100, max_depth=64)
CONFIG4 = dict(nx=1200, ny=800, ns=100, max_depth=64)
DRAGON = dict(nx=512, ny=512, ns=4, max_depth=50, textures=False)
SMALL = dict(nx=96, ny=64, ns=4, max_depth=8)
HIRES = dict(prims_per_leaf=64, sub=20)          # bench.py:305
DRAGON_MESH = dict(nu=1664, nv=262)              # main.py:47
BVH_RAYS = 131_072
ASSETS = os.path.join(ROOT, "assets")
GOLDEN = os.path.join(ASSETS, "bench_spheres_100spp.ref")
STAIR_GOLDEN = os.path.join(ASSETS, "bench_staircase_toy_100spp.ref")
HIRES_GOLDEN = os.path.join(ASSETS, "bench_staircase_hires_2spp.ref")
DRAGON_GOLDEN = os.path.join(ASSETS, "bench_dragon_4spp.ref")
RMSE_TOL, SSIM_MIN = 5e-3, 0.99  # the oracle-gate bounds of bench.py
T_RTOL = 2.0 ** -22              # 2 ulp: -fmad=false makes t bit-equal
# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W)
FP32_FLOPS, HBM_BYTES = 67e12, 3.35e12
# FP32 operations counted from the kernels' sources (compares not
# counted): a ray-sphere pair (spheres.cu), a ray-triangle slot
# (bvh_common.cuh mt_hit, its division counted as one), a slab test
SPHERE_FLOPS, MT_FLOPS, SLAB_FLOPS = 20, 37, 12
TRI_ROW_BYTES = 48  # a [T, 12] f32 triangle row: v0, e1, e2, n
NO_LIBRARY = None  # no single PyTorch call computes these hits


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps=7):
    """Median milliseconds of ``fn`` on the current stream, warm."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of flops over its FP32 rate and bytes over its memory
    rate."""
    t_ops = flops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def record(name, source, replaces, launches, err, ms, plain_ms, bnd):
    return {"name": name, "route": "cuda",
            "source": f"tpu_pathtracer_torch/csrc/{source}",
            "replaces": f"tpu_pathtracer/ops/{replaces}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": NO_LIBRARY}


def ties_within_ulp(origin, direction, tab, ik, ip, lanes, t_min, t_max):
    """True if on every lane in ``lanes`` the kernel's and the plain
    version's winners have t values within 1 ulp (a tie the two may
    break differently)."""
    for j in lanes.tolist():
        if min(int(ik[j]), int(ip[j])) < 0:
            return False  # a hit against a miss is no tie
        one = lambda v: V3(*(c[j:j + 1] for c in v))
        rows = tab[torch.stack([ik[j], ip[j]]).long()]
        ts = cs._sphere_ts(one(origin), one(direction), rows, t_min,
                           torch.full((1,), t_max, device=tab.device))[0]
        if torch.nextafter(ts.min(), ts.new_tensor(np.inf)) < ts.max():
            return False
    return True


def render_timed(fn):
    """(result, seconds by CUDA events, host wall seconds) of ``fn``."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    w0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b) / 1e3, time.perf_counter() - w0


def gate_crop(tag, img, path):
    """The 128x128 center crop of ``img`` against a committed golden."""
    ny, nx = img.shape[:2]
    if not np.isfinite(img).all():
        raise AssertionError(f"{tag}: non-finite pixels")
    cy, cx = ny // 2, nx // 2
    crop = np.ascontiguousarray(img[cy - 64:cy + 64, cx - 64:cx + 64])
    ref = golden.load_reference(path)
    r, s = golden.rmse(crop, ref), golden.ssim(crop, ref)
    if not (r < RMSE_TOL and s >= SSIM_MIN):
        raise AssertionError(f"{tag} crop vs golden: rmse {r:.3e} "
                             f"ssim {s:.5f}")
    return r, s


def small_renders(tag, scene, cam, cfg, patches):
    """``cfg`` rendered through the kernels and through the plain
    versions (``patches``: (module, name, plain function) triples): the
    images must agree (rmse < 5e-3, SSIM >= 0.99; measured bit-equal).
    Returns the kernels' image."""
    img_k = render_image_regen(scene, cam, cfg)
    with contextlib.ExitStack() as stack:
        for mod, name, fn in patches:
            stack.enter_context(mock.patch.object(mod, name, fn))
        img_p = render_image_regen(scene, cam, cfg)
    r, s = golden.rmse(img_k, img_p), golden.ssim(img_k, img_p)
    if not (np.isfinite(img_k).all() and r < RMSE_TOL and s >= SSIM_MIN):
        raise AssertionError(f"{tag} small render: rmse {r:.3e} "
                             f"ssim {s:.5f}")
    phase("small", f"{tag} {cfg.nx}x{cfg.ny} {cfg.ns} spp depth "
          f"{cfg.max_depth}: kernel vs plain rmse {r:.3e} ssim {s:.6f} "
          f"max |diff| {np.abs(img_k - img_p).max():.3e}")
    return img_k


def first_bounce(scene, view, cfg, o1, d1, pix, patches):
    """Bounce 0 of the rays ``o1``/``d1`` through the plain versions.
    Returns (the second-bounce rays with t_max = -1 on dead lanes, the
    NEE shadow rays as they reach the any-hit test)."""
    shadow = {}
    real = wf.occluded

    def catch(scene_, view_, config_, origin, direction, t_max):
        shadow.update(origin=origin, direction=direction,
                      t_max=t_max.contiguous())
        return real(scene_, view_, config_, origin, direction, t_max)

    alive = torch.ones_like(pix, dtype=torch.bool)
    with contextlib.ExitStack() as stack:
        for mod, name, fn in patches:
            stack.enter_context(mock.patch.object(mod, name, fn))
        stack.enter_context(mock.patch.object(wf, "occluded", catch))
        st, _ = wf.bounce_step(scene, view, cfg,
                               wf.initial_state(o1, d1, alive), pix, 0, 0)
    o2 = V3(*(c.contiguous() for c in st.origin))
    d2 = V3(*(c.contiguous() for c in st.direction))
    t2 = torch.where(st.alive, FLT_MAX, -1.0).contiguous()
    return (o2, d2, t2), (shadow["origin"], shadow["direction"],
                          shadow["t_max"])


def compare_modes(tag, origin, direction, view, eps, flt_max):
    """All three sphere modes, kernel against plain, on one ray set.
    Returns (max abs error over t and features, kernel ms, plain ms) of
    the features mode."""
    args = (origin, direction, view.sph_c, view.sph_r)
    t_k, i_k, f_k = cs.spheres_hit_feat(*args, view.sph_feat, eps, flt_max)
    t_p, i_p, f_p = cs._spheres_hit_feat_ref(*args, view.sph_feat, eps,
                                             flt_max)
    torch.cuda.synchronize()
    mism = (i_k != i_p).nonzero().flatten()
    if mism.numel() > 1000:
        raise AssertionError(f"{tag}: idx differs on {mism.numel()} lanes")
    tab = cs.sphere_table(view.sph_c, view.sph_r)
    if not ties_within_ulp(origin, direction, tab, i_k, i_p, mism, eps,
                           flt_max):
        raise AssertionError(f"{tag}: idx differs where t does not tie")
    same = i_k == i_p
    hit = same & (i_k >= 0)
    dt = (t_k - t_p)[hit].abs()
    if bool((dt > T_RTOL * t_p[hit].abs()).any()):
        raise AssertionError(f"{tag}: t differs by {dt.max().item():.3e}")
    if not bool((t_k[i_k < 0] == t_p.new_tensor(flt_max)).all()):
        raise AssertionError(f"{tag}: a miss lane has t != FLT_MAX")
    fk, fp = torch.stack(f_k), torch.stack(f_p)
    if not torch.equal(fk[:, hit], fp[:, hit]):
        raise AssertionError(f"{tag}: features differ on hit lanes")
    if bool((fk[:, i_k < 0] != 0).any()):
        raise AssertionError(f"{tag}: features nonzero on miss lanes")
    err = max(dt.max().item() if dt.numel() else 0.0,
              (fk[:, hit] - fp[:, hit]).abs().max().item())

    t2_k, i2_k = cs.spheres_hit_soa(*args, eps, flt_max)
    t2_p, i2_p = cs._spheres_hit_ref(*args, eps, flt_max)
    if not (torch.equal(i2_k, i_k) and torch.equal(t2_k, t_k)):
        raise AssertionError(f"{tag}: t/idx mode differs from features "
                             "mode")
    if not torch.equal(i2_p, i_p):
        raise AssertionError(f"{tag}: plain t/idx differs from plain "
                             "features")
    # any-hit against a per-ray t_max just past the plain hit distance on
    # even lanes and at half of it on odd ones, so both outcomes occur
    odd = torch.arange(t_p.numel(), device=t_p.device) % 2 == 1
    tm = torch.where(i_p >= 0, t_p * torch.where(odd, 0.5, 1.001), flt_max)
    o_k = cs.spheres_anyhit_soa(*args, eps, tm)
    o_p = cs._spheres_anyhit_ref(*args, eps, tm)
    if not torch.equal(o_k, o_p):
        raise AssertionError(f"{tag}: any-hit differs on "
                             f"{(o_k != o_p).sum().item()} lanes")

    ms = cuda_ms(lambda: cs.spheres_hit_feat(*args, view.sph_feat, eps,
                                             flt_max))
    plain_ms = cuda_ms(lambda: cs._spheres_hit_feat_ref(
        *args, view.sph_feat, eps, flt_max))
    ms_soa = cuda_ms(lambda: cs.spheres_hit_soa(*args, eps, flt_max))
    plain_soa = cuda_ms(lambda: cs._spheres_hit_ref(*args, eps, flt_max))
    ms_any = cuda_ms(lambda: cs.spheres_anyhit_soa(*args, eps, tm))
    plain_any = cuda_ms(lambda: cs._spheres_anyhit_ref(*args, eps, tm))
    n, s = origin.x.shape[0], view.sph_r.shape[0]
    bnd = bound(n * s * SPHERE_FLOPS, n * (28 + 8 + 72) + s * (16 + 72))
    phase("kernel", f"{tag}: {n} rays x {s} spheres: idx equal on "
          f"{int(same.sum())}/{same.numel()} lanes ({mism.numel()} ties), "
          f"hits {int(hit.sum())}, max |err| t+features {err:.3e}, "
          f"occ equal ({int(o_k.sum())} occluded); features "
          f"{ms:.3f} ms vs plain {plain_ms:.3f} ms (bound {bnd[0]:.4f} ms "
          f"by {bnd[1]}), t/idx {ms_soa:.3f} ms vs plain {plain_soa:.3f} "
          f"ms, any-hit {ms_any:.3f} ms vs plain {plain_any:.3f} ms")
    return err, ms, plain_ms, bnd


def compare_tri_nearest(tag, origin, direction, view, eps, t_max):
    """The triangle kernel's features and t/idx modes against the plain
    version on one ray set. Returns (max abs error over t, u, v and
    features, features ms, plain ms, bound)."""
    tris = (view.tri_v0, view.tri_e1, view.tri_e2, view.tri_n)
    args = (origin, direction, *tris)
    k = ct.tris_hit_feat(*args, view.tri_feat, eps, t_max)
    p = ct._tris_hit_feat_ref(*args, view.tri_feat, eps, t_max)
    torch.cuda.synchronize()
    (t_k, i_k, u_k, v_k, f_k), (t_p, i_p, u_p, v_p, f_p) = k, p
    mism = (i_k != i_p).nonzero().flatten()
    if mism.numel() > 1000:
        raise AssertionError(f"{tag}: idx differs on {mism.numel()} lanes")
    # a lane whose winners differ must be a tie: both hit, t within 1 ulp
    tk, tp = t_k[mism], t_p[mism]
    if bool(((i_k[mism] < 0) | (i_p[mism] < 0)
             | (torch.nextafter(torch.minimum(tk, tp),
                                tk.new_tensor(np.inf))
                < torch.maximum(tk, tp))).any()):
        raise AssertionError(f"{tag}: idx differs where t does not tie")
    same = i_k == i_p
    hit = same & (i_k >= 0)
    dt = (t_k - t_p)[hit].abs()
    if bool((dt > T_RTOL * t_p[hit].abs()).any()):
        raise AssertionError(f"{tag}: t differs by {dt.max().item():.3e}")
    miss = i_k < 0
    if not bool((t_k[miss] == t_k.new_tensor(FLT_MAX)).all()
                and (u_k[miss] == 0).all() and (v_k[miss] == 0).all()):
        raise AssertionError(f"{tag}: a miss lane has t != FLT_MAX or "
                             "u, v != 0")
    fk, fp = torch.stack(f_k), torch.stack(f_p)
    if not (torch.equal(u_k[hit], u_p[hit])
            and torch.equal(v_k[hit], v_p[hit])
            and torch.equal(fk[:, hit], fp[:, hit])):
        raise AssertionError(f"{tag}: u, v or features differ on hit "
                             "lanes")
    if bool((fk[:, miss] != 0).any()):
        raise AssertionError(f"{tag}: features nonzero on miss lanes")
    err = max(dt.max().item() if dt.numel() else 0.0,
              (fk[:, hit] - fp[:, hit]).abs().max().item())
    k2 = ct.tris_hit_soa(*args, eps, t_max)
    if not all(torch.equal(a, b) for a, b in zip(k2, k[:4])):
        raise AssertionError(f"{tag}: t/idx mode differs from features "
                             "mode")
    ms = cuda_ms(lambda: ct.tris_hit_feat(*args, view.tri_feat, eps,
                                          t_max))
    plain_ms = cuda_ms(lambda: ct._tris_hit_feat_ref(*args, view.tri_feat,
                                                     eps, t_max))
    ms_soa = cuda_ms(lambda: ct.tris_hit_soa(*args, eps, t_max))
    plain_soa = cuda_ms(lambda: ct._tris_hit_ref(*args, eps, t_max))
    n, T = origin.x.shape[0], view.tri_v0.x.shape[0]
    bnd = bound(n * T * MT_FLOPS, n * (28 + 16 + 104) + T * (48 + 104))
    phase("kernel", f"{tag}: {n} rays x {T} triangles: idx equal on "
          f"{int(same.sum())}/{same.numel()} lanes ({mism.numel()} ties), "
          f"hits {int(hit.sum())}, max |err| t+features {err:.3e}, u/v "
          f"bit-equal; features {ms:.3f} ms vs plain {plain_ms:.3f} ms "
          f"(bound {bnd[0]:.4f} ms by {bnd[1]}), t/idx {ms_soa:.3f} ms vs "
          f"plain {plain_soa:.3f} ms")
    return err, ms, plain_ms, bnd


def tri_slots_tested(origin, direction, view, eps, t_max):
    """Triangle tests the any-hit kernel needs on these rays: up to and
    including the first hit in slot order, all of them without one, none
    on a lane with t_max <= t_min."""
    tab = ct.tri_table(view.tri_v0, view.tri_e1, view.tri_e2, view.tri_n)
    n, T = origin.x.shape[0], tab.shape[0]
    tested = torch.full((n,), T, dtype=torch.int64, device=tab.device)
    found = torch.zeros((n,), dtype=torch.bool, device=tab.device)
    for base in range(0, T, ct.T_CHUNK):
        *_, bad = ct._tri_step(origin, direction,
                               tab[base:base + ct.T_CHUNK], eps, t_max)
        ok = ~bad
        has = ok.any(dim=1)
        first = ok.to(torch.uint8).argmax(dim=1)
        tested = torch.where(has & ~found, base + first + 1, tested)
        found = found | has
    return int(torch.where(t_max > eps, tested, 0).sum())


def compare_tri_anyhit(tag, origin, direction, view, eps, t_max):
    """The triangle kernel's any-hit mode against the plain version.
    Returns (lanes whose occlusion differs, kernel ms, plain ms, bound)."""
    args = (origin, direction, view.tri_v0, view.tri_e1, view.tri_e2,
            view.tri_n, eps, t_max)
    o_k = ct.tris_anyhit_soa(*args)
    o_p = ct._tris_anyhit_ref(*args)
    differ = int((o_k != o_p).sum())
    if differ:
        raise AssertionError(f"{tag}: any-hit differs on {differ} lanes")
    if bool(o_k[t_max <= eps].any()):
        raise AssertionError(f"{tag}: a lane without a shadow ray is "
                             "occluded")
    ms = cuda_ms(lambda: ct.tris_anyhit_soa(*args))
    plain_ms = cuda_ms(lambda: ct._tris_anyhit_ref(*args))
    n, T = origin.x.shape[0], view.tri_v0.x.shape[0]
    tests = tri_slots_tested(origin, direction, view, eps, t_max)
    bnd = bound(tests * MT_FLOPS, n * 29 + T * 48)
    phase("kernel", f"{tag}: {n} rays ({int((t_max > eps).sum())} shadow "
          f"rays) x {T} triangles: occ equal ({int(o_k.sum())} occluded); "
          f"any-hit {ms:.3f} ms vs plain {plain_ms:.3f} ms ({tests} "
          f"triangle tests, bound {bnd[0]:.4f} ms by {bnd[1]})")
    return differ, ms, plain_ms, bnd


def build_all():
    """Build the four kernels and the BVH builder side by side."""
    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        return out, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        futs = {name: ex.submit(timed, _build.build, name)
                for name in ("spheres", "tris", "bvh", "bvh4")}
        bvh = ex.submit(timed, native.load)
        for name, fut in futs.items():
            lib, secs = fut.result()
            ptxas = [ln.strip() for ln in
                     lib.with_suffix(".log").read_text().splitlines()
                     if "registers" in ln or "spill" in ln]
            phase("build", f"{name}.cu built in {secs:.1f} s: "
                  + " | ".join(ptxas))
        lib, secs = bvh.result()
    phase("build", "BVH builder: " + (
        f"native SAH (g++, {secs:.1f} s)" if lib is not None
        else "NumPy median (the native builder did not build)"))


def spheres_path(dev):
    """Phases 3-5. Returns the kernel's JSON record."""
    cfg = RenderConfig(**HEADLINE)
    scene, cam = random_spheres_scene(cfg.nx, cfg.ny, device=dev)
    view = wf.make_view(scene, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    err1, ms, plain_ms, bnd = compare_modes("spheres primary", o1, d1, view,
                                            cfg.epsilon, FLT_MAX)
    with mock.patch.object(cs, "spheres_hit_feat", cs._spheres_hit_feat_ref):
        st, _ = wf.bounce_step(scene, view, cfg,
                               wf.initial_state(o1, d1, torch.ones_like(
                                   pix, dtype=torch.bool)), pix, 0, 0)
    live = st.alive
    o2 = V3(*(c[live].contiguous() for c in st.origin))
    d2 = V3(*(c[live].contiguous() for c in st.direction))
    err2, _, _, _ = compare_modes("spheres bounce-2", o2, d2, view,
                                  cfg.epsilon, FLT_MAX)

    scfg = RenderConfig(**SMALL)
    sscene, scam = random_spheres_scene(scfg.nx, scfg.ny, device=dev)
    small_renders("spheres", sscene, scam, scfg,
                  [(cs, "spheres_hit_feat", cs._spheres_hit_feat_ref)])

    render_image_regen(scene, cam, cfg, ns=1)  # warm-up
    cs.LAUNCHES = 0
    img, secs, wall = render_timed(lambda: render_image_regen(scene, cam,
                                                              cfg))
    launches = cs.LAUNCHES
    if launches <= 0:
        raise AssertionError("the headline render launched no sphere kernel")
    if img.shape != (cfg.ny, cfg.nx, 3):
        raise AssertionError(f"bad image: shape {img.shape}")
    r5, s5 = gate_crop("headline", img, GOLDEN)
    paths = cfg.num_pixels * cfg.ns
    phase("headline", f"{cfg.nx}x{cfg.ny} {cfg.ns} spp depth "
          f"{cfg.max_depth}: {secs:.3f} s (CUDA events; host wall "
          f"{wall:.3f} s), {paths / secs / 1e6:.3f} Mpaths/s, "
          f"{launches} kernel launches = regen iterations, mean "
          f"{img.mean():.4f}; crop vs TPU golden rmse {r5:.3e} "
          f"ssim {s5:.6f}")
    return record("spheres_hit_feat", "spheres.cu", "pallas_spheres.py:73",
                  launches, max(err1, err2), ms, plain_ms, bnd)


def staircase_path(dev):
    """Phases 6-8. Returns the kernel's JSON records (features mode, the
    nearest hit of the path, and any-hit, its shadow rays)."""
    cfg = RenderConfig(**STAIRCASE)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny, device=dev)
    view = wf.make_view(scene, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    err1, ms, plain_ms, bnd = compare_tri_nearest(
        "tris primary", o1, d1, view, cfg.epsilon, FLT_MAX)
    plain = [(ct, "tris_hit_feat", ct._tris_hit_feat_ref),
             (ct, "tris_anyhit_soa", ct._tris_anyhit_ref)]
    (o2, d2, t2), shadow = first_bounce(scene, view, cfg, o1, d1, pix,
                                        plain)
    err2, _, _, _ = compare_tri_nearest("tris bounce-2", o2, d2, view,
                                        cfg.epsilon, t2)
    err_any, ms_any, plain_any, bnd_any = compare_tri_anyhit(
        "tris NEE shadows", *shadow[:2], view, cfg.epsilon, shadow[2])

    scfg = RenderConfig(**SMALL)
    sscene, scam = procedural_staircase_scene(scfg.nx, scfg.ny, device=dev)
    small_renders("staircase", sscene, scam, scfg, plain)

    render_regen(scene, cam, cfg, ns=1)  # warm-up
    for key in ct.LAUNCHES:
        ct.LAUNCHES[key] = 0
    (fb, iters), secs, wall = render_timed(
        lambda: render_regen(scene, cam, cfg, return_iters=True))
    launches = dict(ct.LAUNCHES)
    if launches["features"] <= 0 or launches["any_hit"] <= 0:
        raise AssertionError(f"the staircase render launched the nearest "
                             f"and any-hit kernels {launches} times")
    img = fb.cpu().numpy().reshape(cfg.ny, cfg.nx, 3)
    r8, s8 = gate_crop("staircase", img, STAIR_GOLDEN)
    paths = cfg.num_pixels * cfg.ns
    phase("staircase", f"{cfg.nx}x{cfg.ny} {cfg.ns} spp depth "
          f"{cfg.max_depth}: {secs:.3f} s (CUDA events; host wall "
          f"{wall:.3f} s), {paths / secs / 1e6:.3f} Mpaths/s, {iters} "
          f"regen iterations, kernel launches {launches}, mean "
          f"{img.mean():.4f}; crop vs TPU golden rmse {r8:.3e} "
          f"ssim {s8:.6f}")
    return [record("tris_hit_feat", "tris.cu", "pallas_tris.py:77",
                   launches["features"], max(err1, err2), ms, plain_ms,
                   bnd),
            record("tris_anyhit_soa", "tris.cu", "pallas_tris.py:77",
                   launches["any_hit"], err_any, ms_any, plain_any,
                   bnd_any)]


def profile_frame(tag, scene, cam, cfg):
    """Phase 14: one sample per pixel of the middle rows of ``cfg``'s
    frame (two lane pools' worth of pixels) timed without the profiler,
    then under torch.profiler; prints host dispatches and device kernel
    time per regen iteration and the device's busy share (profiled device
    time over the unprofiled wall time)."""
    from torch.profiler import ProfilerActivity, profile
    one = cfg.replace(ns=1)
    n = min(cfg.num_pixels,
            2 * _pool_size(one, cfg.num_pixels, scene))
    rows = dict(pixel_offset=(cfg.num_pixels - n) // 2, num_pixels=n)
    render_regen(scene, cam, one, **rows)  # warm-up
    (_, iters), secs, _ = render_timed(
        lambda: render_regen(scene, cam, one, return_iters=True, **rows))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_regen(scene, cam, one, **rows)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device time: the kernel events' own (the CPU ops that launch them
    # carry the same time again)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    top = sorted(kernels, key=dev_us, reverse=True)[:4]
    short = lambda k: k.replace("void ", "").replace("at::native::", "")[:72]
    per_iter = secs / iters * 1e3
    head = f"{tag} 1 spp over {n} pixels: {iters} iterations, "
    if device_ms <= 0:
        phase("profile", f"{head}{per_iter:.2f} ms each; device time not "
              "measured (the profiler reported none)")
        return
    phase("profile", f"{head}{per_iter:.2f} ms each unprofiled; profiled "
          f"{launches / iters:.0f} kernel "
          f"launches and {device_ms / iters:.3f} ms of device time an "
          f"iteration, device busy {device_ms / iters / per_iter:.1%}; "
          "top: " + ", ".join(
              f"{short(e.key)} {dev_us(e) / 1e3 / iters:.3f} ms/iter"
              for e in top))


class BvhKernels:
    """The wrappers of one BVH tier, its plain versions and its cost
    model (slab tests a node step, triangle slots a leaf visit, the bytes
    of a node row and of a leaf's triangle rows)."""

    def __init__(self, tier, tabs):
        self.tier, self.tabs = tier, tabs
        if tier == "bvh4":
            self.mod, self.slabs, self.slots = cb4, 4, tabs.width
            self.walk = cb4._bvh4_walk_ref
            self.node_bytes = 4 * (6 * 4 + 4)  # four child boxes and refs
        else:
            self.mod, self.slabs, self.slots = cb, 2, tabs.prims_per_leaf
            self.walk = cb._heap_walk_ref
            self.node_bytes = 6 * 4  # one child box (min, max)
        name = "bvh4" if tier == "bvh4" else "heap"
        self.trace = getattr(self.mod, f"{name}_trace")
        self.occluded = getattr(self.mod, f"{name}_occluded")
        self.trace_ref = getattr(self.mod, f"_{name}_trace_ref")
        self.occluded_ref = getattr(self.mod, f"_{name}_occluded_ref")

    def plain(self):
        """Patches that send the engine through the plain versions."""
        return [(self.mod, self.trace.__name__, self.trace_ref),
                (self.mod, self.occluded.__name__, self.occluded_ref)]

    def walk_plain(self, origin, direction, t_max, eps, any_hit):
        """The plain walk, and the distinct node rows and leaves it read.
        Returns (t, tri, occ, counters, nodes read, leaves read)."""
        visits = {"nodes": [], "leaves": []}
        out = self.walk(origin, direction, t_max, self.tabs, eps,
                        any_hit=any_hit, visits=visits)
        distinct = lambda ids: (torch.unique(torch.cat(ids)).numel()
                                if ids else 0)
        return (*out, distinct(visits["nodes"]), distinct(visits["leaves"]))

    def table_bytes(self, nodes, leaves):
        """Bytes of the distinct table rows a walk needs, each read
        once."""
        return nodes * self.node_bytes + leaves * self.slots * TRI_ROW_BYTES

    def nearest_flops(self, n, cnt):
        c = cnt.sum(dim=1, dtype=torch.int64)
        return (3 * n + int(c[4]) * self.slabs * SLAB_FLOPS
                + int(c[2]) * self.slots * MT_FLOPS)

    def anyhit_flops(self, n, cnt, occ, best):
        """As nearest, but the last visit of an occluded ray tests only
        the slots up to its first hit."""
        c = cnt.sum(dim=1, dtype=torch.int64)
        last = int((best[occ].to(torch.int64) % self.slots + 1).sum())
        slots = (int(c[2]) - int(occ.sum())) * self.slots + last
        return (3 * n + int(c[4]) * self.slabs * SLAB_FLOPS
                + slots * MT_FLOPS)


def compare_bvh_nearest(tag, kern, origin, direction, t_max, eps):
    """A BVH tier's nearest-hit kernel against its plain version: t
    bit-equal, winners equal except exact ties, per-ray counters equal.
    Returns (max abs error of t, kernel ms, plain ms, bound)."""
    tabs = kern.tabs
    t_k, i_k, c_k = kern.trace(origin, direction, t_max, tabs, eps)
    t_p, i_p, _, c_p, nodes, leaves = kern.walk_plain(origin, direction,
                                                      t_max, eps, False)
    torch.cuda.synchronize()
    if kern.tier == "bvh4":
        cb4.check_stack(tabs)
    err = (t_k - t_p).abs().max().item()
    if not torch.equal(t_k, t_p):
        bad = t_k != t_p
        raise AssertionError(f"{tag}: t differs on {int(bad.sum())} lanes "
                             f"(max {(t_k - t_p)[bad].abs().max():.3e})")
    mism = i_k != i_p
    if bool((mism & ((i_k < 0) | (i_p < 0))).any()) or \
            int(mism.sum()) > i_k.numel() // 1000:
        raise AssertionError(f"{tag}: winners differ on "
                             f"{int(mism.sum())} lanes")
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"{tag}: per-ray counters differ on "
                             f"{int((c_k != c_p).any(0).sum())} lanes")
    ms = cuda_ms(lambda: kern.trace(origin, direction, t_max, tabs, eps))
    plain_ms = cuda_ms(lambda: kern.trace_ref(origin, direction, t_max,
                                              tabs, eps), reps=2)
    n = origin.x.shape[0]
    bnd = bound(kern.nearest_flops(n, c_k), n * (28 + 8 + 20)
                + kern.table_bytes(nodes, leaves))
    c = c_k.sum(dim=1, dtype=torch.int64).tolist()
    phase("kernel", f"{tag}: {n} rays ({int((t_max > 0).sum())} live): "
          f"t bit-equal, winners equal on {n - int(mism.sum())}/{n} lanes "
          f"({int(mism.sum())} ties), hits {int((i_k >= 0).sum())}, "
          f"counters equal {dict(zip(cb.COUNTERS, c))}; read {nodes} "
          f"distinct node rows, {leaves} leaves; kernel {ms:.3f} ms vs "
          f"plain {plain_ms:.3f} ms (bound {bnd[0]:.4f} ms by {bnd[1]})")
    return err, ms, plain_ms, bnd


def compare_bvh_anyhit(tag, kern, origin, direction, t_max, eps):
    """A BVH tier's any-hit kernel against its plain version: occlusion
    and per-ray counters equal. Returns (lanes whose occlusion differs,
    kernel ms, plain ms, bound)."""
    tabs = kern.tabs
    o_k, c_k = kern.occluded(origin, direction, t_max, tabs, eps)
    _, best, o_p, c_p, nodes, leaves = kern.walk_plain(origin, direction,
                                                       t_max, eps, True)
    torch.cuda.synchronize()
    if kern.tier == "bvh4":
        cb4.check_stack(tabs)
    differ = int((o_k != o_p).sum())
    if differ or not torch.equal(c_k, c_p):
        raise AssertionError(f"{tag}: any-hit differs on {differ} lanes, "
                             f"counters on "
                             f"{int((c_k != c_p).any(0).sum())}")
    if bool(o_k[t_max <= 0].any()):
        raise AssertionError(f"{tag}: a lane without a shadow ray is "
                             "occluded")
    ms = cuda_ms(lambda: kern.occluded(origin, direction, t_max, tabs, eps))
    plain_ms = cuda_ms(lambda: kern.occluded_ref(origin, direction, t_max,
                                                 tabs, eps), reps=2)
    n = origin.x.shape[0]
    bnd = bound(kern.anyhit_flops(n, c_k, o_k, best),
                n * (28 + 1 + 20) + kern.table_bytes(nodes, leaves))
    phase("kernel", f"{tag}: {n} lanes ({int((t_max > 0).sum())} shadow "
          f"rays): occ equal ({int(o_k.sum())} occluded), counters equal; "
          f"read {nodes} distinct node rows, {leaves} leaves; kernel "
          f"{ms:.3f} ms vs plain {plain_ms:.3f} ms (bound {bnd[0]:.4f} ms "
          f"by {bnd[1]})")
    return differ, ms, plain_ms, bnd


def bvh_kernel_phase(tag, scene, cam, cfg, kern):
    """Phases 9 and 10: the tier's kernels against their plain versions
    on BVH_RAYS primary rays taken from across the frame, the same lanes'
    second-bounce rays and their NEE shadow rays. Returns (err, ms,
    plain_ms, bound) of nearest and of any-hit."""
    dev = cam.device
    view = wf.make_view(scene, cfg)
    pix = torch.linspace(0, cfg.num_pixels - 1, BVH_RAYS,
                         device=dev).to(torch.int64)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    eps = cfg.epsilon
    near = compare_bvh_nearest(f"{tag} primary", kern, o1, d1,
                               torch.full((BVH_RAYS,), FLT_MAX, device=dev),
                               eps)
    (o2, d2, t2), shadow = first_bounce(scene, view, cfg, o1, d1, pix,
                                        kern.plain())
    compare_bvh_nearest(f"{tag} bounce-2", kern, o2, d2, t2, eps)
    anyh = compare_bvh_anyhit(f"{tag} NEE shadows", kern, *shadow, eps)
    return near, anyh


def staircase_hires_path(dev):
    """Phases 9, 11 and 12. Returns the JSON records of K8 and K9."""
    cfg = RenderConfig(**CONFIG4)
    t0 = time.perf_counter()
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny, device=dev,
                                            **HIRES)
    b4 = scene.mesh.bvh4
    phase("scene", f"staircase-hires built in {time.perf_counter() - t0:.1f}"
          f" s: {scene.mesh.num_tris} heap slots, tier "
          f"{wf.mesh_tier(scene, cfg)}, BVH4 {b4.n_nodes} nodes, "
          f"{b4.n_clusters} clusters of {b4.width}, stack_cap "
          f"{b4.stack_cap}, quant {b4.quant}")
    kern = BvhKernels("bvh4", cb4.bvh4_tables(b4))
    (err, ms, plain_ms, bnd), (err_a, ms_a, plain_a, bnd_a) = \
        bvh_kernel_phase("bvh4 staircase-hires", scene, cam, cfg, kern)

    scfg = RenderConfig(**SMALL)
    sscene, scam = procedural_staircase_scene(scfg.nx, scfg.ny, device=dev,
                                              **HIRES)
    img4 = small_renders("staircase-hires", sscene, scam, scfg,
                         kern.plain())
    for key in cb.LAUNCHES:
        cb.LAUNCHES[key] = 0
    img_h = render_image_regen(sscene, scam, scfg.replace(bvh4=False))
    if min(cb.LAUNCHES.values()) <= 0:
        raise AssertionError("bvh4=False did not run the heap kernels")
    r, s = golden.rmse(img_h, img4), golden.ssim(img_h, img4)
    if not (r < RMSE_TOL and s >= SSIM_MIN):
        raise AssertionError(f"heap vs BVH4 small render: rmse {r:.3e} "
                             f"ssim {s:.5f}")
    phase("small", f"staircase-hires bvh4=False (heap kernels "
          f"{dict(cb.LAUNCHES)}) vs BVH4: rmse {r:.3e} ssim {s:.6f} max "
          f"|diff| {np.abs(img_h - img4).max():.3e}")

    # config 4: the 2 spp golden gate (also the warm-up), then 100 spp
    fb2 = render_regen(scene, cam, cfg, ns=2)
    img2 = fb2.cpu().numpy().reshape(cfg.ny, cfg.nx, 3)
    r2, s2 = gate_crop("staircase-hires 2 spp", img2, HIRES_GOLDEN)
    phase("config4", f"{cfg.nx}x{cfg.ny} 2 spp: crop vs TPU golden rmse "
          f"{r2:.3e} ssim {s2:.6f}, mean {img2.mean():.4f}")
    for mod in (cb4, cb, ct):
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0
    (fb, iters), secs, wall = render_timed(
        lambda: render_regen(scene, cam, cfg, return_iters=True))
    launches = dict(cb4.LAUNCHES)
    other = sum(cb.LAUNCHES.values()) + sum(ct.LAUNCHES.values())
    if min(launches.values()) <= 0 or other:
        raise AssertionError(f"config 4 launched BVH4 {launches}, other "
                             f"triangle kernels {other} times")
    img = fb.cpu().numpy().reshape(cfg.ny, cfg.nx, 3)
    if not np.isfinite(img).all() or img.mean() <= 0:
        raise AssertionError("config 4: non-finite or black image")
    paths = cfg.num_pixels * cfg.ns
    phase("config4", f"{cfg.nx}x{cfg.ny} {cfg.ns} spp depth "
          f"{cfg.max_depth}: {secs:.3f} s (CUDA events; host wall "
          f"{wall:.3f} s), {paths / secs / 1e6:.3f} Mpaths/s, {iters} "
          f"regen iterations ({secs / iters * 1e3:.2f} ms each), kernel "
          f"launches {launches}, mean {img.mean():.4f}")
    profile_frame("config 4", scene, cam, cfg)
    return [record("bvh4_trace", "bvh4.cu", "pallas_bvh4.py:295",
                   launches["nearest"], err, ms, plain_ms, bnd),
            record("bvh4_occluded", "bvh4.cu", "pallas_bvh4.py:598",
                   launches["any_hit"], err_a, ms_a, plain_a, bnd_a)]


def dragon_path(dev):
    """Phases 10 and 13. Returns the JSON records of K5 and K6."""
    cfg = RenderConfig(**DRAGON)
    t0 = time.perf_counter()
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, device=dev, **DRAGON_MESH)
    if wf.mesh_tier(scene, cfg) != "heap":
        raise AssertionError("the dragon-class knot left the heap tier")
    phase("scene", f"dragon-class knot built in "
          f"{time.perf_counter() - t0:.1f} s: {scene.mesh.num_tris} heap "
          f"slots, first_leaf {scene.mesh.first_leaf}, "
          f"{scene.mesh.prims_per_leaf} a leaf, tier heap")
    kern = BvhKernels("heap", cb.heap_tables(scene.mesh))
    (err, ms, plain_ms, bnd), (err_a, ms_a, plain_a, bnd_a) = \
        bvh_kernel_phase("heap dragon", scene, cam, cfg, kern)

    render_regen(scene, cam, cfg, ns=1)  # warm-up
    for mod in (cb4, cb, ct):
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0
    (fb, iters), secs, wall = render_timed(
        lambda: render_regen(scene, cam, cfg, return_iters=True))
    launches = dict(cb.LAUNCHES)
    other = sum(cb4.LAUNCHES.values()) + sum(ct.LAUNCHES.values())
    if min(launches.values()) <= 0 or other:
        raise AssertionError(f"the dragon launched heap {launches}, other "
                             f"triangle kernels {other} times")
    img = fb.cpu().numpy().reshape(cfg.ny, cfg.nx, 3)
    r, s = gate_crop("dragon", img, DRAGON_GOLDEN)
    paths = cfg.num_pixels * cfg.ns
    phase("dragon", f"{cfg.nx}x{cfg.ny} {cfg.ns} spp depth "
          f"{cfg.max_depth}: {secs:.3f} s (CUDA events; host wall "
          f"{wall:.3f} s), {paths / secs / 1e6:.3f} Mpaths/s, {iters} "
          f"regen iterations, kernel launches {launches}, mean "
          f"{img.mean():.4f}; crop vs TPU golden rmse {r:.3e} "
          f"ssim {s:.6f}")
    return [record("heap_trace", "bvh.cu", "pallas_bvh.py:937",
                   launches["nearest"], err, ms, plain_ms, bnd),
            record("heap_occluded", "bvh.cu", "pallas_bvh.py:1393",
                   launches["any_hit"], err_a, ms_a, plain_a, bnd_a)]


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); nothing runs on the CPU in its place")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    build_all()
    kernels = [spheres_path(dev), *staircase_path(dev),
               *staircase_hires_path(dev), *dragon_path(dev)]
    phase("done", f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
