"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's ported paths on the card through
``tpu_pathtracer_torch.engine.regen``: the random-spheres headline
(BASELINE config 3: 1200x800, 100 spp, max depth 50), the procedural
staircase (the staircase-toy row of bench.py: 1200x800, 100 spp, max
depth 64; triangle mesh, textures, NEE shadow rays), the asset-scale
staircase (BASELINE config 4, staircase-hires: 154k triangles, the SAH
BVH4 tier) and the dragon-class knot (872k triangles, the heap BVH
tier), also under the knobs that pick the heap tier's other kernels
(mx_leaf, regroup, fast_math, packet_packs with packet_split), and the
entry points of the JAX package's two decision records that no config
reaches: the sphere kernel's mx layout (K2, K3) on the headline's rays
and the packet walk with leaf queues (K12a, K12b) on the dragon's; and
the probes that split K5's time (K13-K16, ``tpu_pathtracer_torch/
experiments``), on the dragon's lanes and on the TPU probes' seeded
inputs. It builds the CUDA kernels from ``tpu_pathtracer_torch/csrc``
first and holds each against its plain PyTorch version at the shapes its
path gives it. Phases, one line each; any failure raises and exits
non-zero:

  1. device: the nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc builds spheres.cu, spheres_mx.cu, tris.cu, bvh.cu,
     bvh4.cu, bvh_mx.cu, bvh_rg.cu, bvh_mr.cu and the probes'
     iter_ablate.cu, leafmt_probe.cu, dma_probe.cu and dual_probe.cu side
     by side, g++ the native BVH builder (seconds, ptxas lines);
  3. spheres, kernel vs plain on the 960,000 primary rays of sample 0 and
     on the second-bounce rays, in all three modes; times (CUDA events,
     median of 7 warm runs);
 3b. the mx layout on the same two ray sets: K2 (nearest + features) and
     K3 (any-hit) through ``spheres_hit_feat``/``spheres_anyhit_soa(mx=
     True)``, counts from 0; each bit-equal to its plain version; against
     K1 and K1c (winners agree on > 0.995 of the lanes, each departure a
     lane the split's error can flip; t within 5e-3 relative plus that
     error and features equal where they agree; occlusion on > 0.999);
     times in turns with K1 and K1c;
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
     then on the same lanes the heap tier's variants: the MXU-leaf kernels
     (K10 nearest, K10b any-hit; the kernel's t, winners, occlusion and
     counters bit-equal), with where K10 departs from the exact K5 at 3
     and 6 passes (winners a neighbour of K5's, pass-throughs, extra hits,
     each counted and bounded; K10b's occlusion flips counted); the
     regrouped kernel (K11: t, winners and counters bit-equal; its leaf
     visits within [1, 1.5]x K5's) and K5/K6's fast_math mode against the
     exact plain walk (t within 2^-20 relative where the winners agree;
     winners, hits and occlusion equal except on lanes with a triangle
     whose exact u, v, u+v, t or |a| lies within 2^-20 of an accept
     bound, counted);
 10c. the packet walk on the same primary and NEE lanes: K12a
     (``mr_trace``) and K12b (``mr_occluded``), counts from 0; t, winners,
     features, occlusion and per-packet counters bit-equal to the plain
     walk; t and occlusion equal to K5's and K6's, winners but exact
     ties; times in turns with K5 and K6; steps and leaf visits per
     packet beside K5's per ray; the bound is K5's and K6's (the same
     function on the same lanes), the packet walk's own work beside it;
 10d. the walk probes on the same primary lanes, counts from 0: K13
     (``iter_ablate.ablate_trace``, modes full, nomt, noleaf; acc and
     per-ray counters bit-equal to the plain walk, the counters equal
     across modes) timed in turns with K5, and the split of its time into
     node walk (noleaf), leaf-row fetch (nomt - noleaf) and leaf
     arithmetic (full - nomt); K16 (``dual_probe.dual_steps`` at R = 1, 2,
     4 rays a thread; step counts bit-equal to the plain node phase)
     timed in turns;
 11. small: staircase-hires 96x64, 4 spp, depth 8, kernels vs plain, and
     with bvh4=False (through K5/K6) against the BVH4 render;
 12. config 4: staircase-hires 1200x800, 2 spp gated against
     assets/bench_staircase_hires_2spp.ref, then 100 spp depth 64 timed:
     seconds, Mpaths/s, regen iterations, launches of each kernel, mean;
 13. dragon: the 872k knot 512x512, 4 spp, depth 50, untextured, timed
     and gated against assets/bench_dragon_4spp.ref; then the same frame
     under mx_leaf, regroup, fast_math and packet_packs=2 with
     packet_split, each timed, its launches read (the variant's kernels
     ran, the default heap kernel it replaces did not, and no frame
     launched the packet walk), gated against the golden and held
     against the default frame: packet_packs bit for bit,
     regroup rmse < 1e-4, fast_math SSIM >= 0.999, mx_leaf SSIM >= 0.999
     and rmse < 2e-3 (MX_FRAME_RMSE), also on two more sample windows,
     and at mx_passes=6 closer to the default than at 3;
 14. profile: one sample per pixel of config 4's frame, over its middle
     rows, two lane pools' worth of pixels (the profiler's cost grows with
     the kernels it records), under torch.profiler: host dispatches and
     device kernel time per regen iteration, the device's busy share, the
     kernels that take most;
 15. the leaf-fetch probes on the TPU probes' seeded inputs, counts from
     0: K14 (``leafmt_probe.leafmt_run``, modes pure, cond, dma, db, db2)
     and K15 (``dma_probe.dma_chain``, sync and db), each bit-equal to its
     plain version at a few visits or copies, then timed at the probes'
     own pair (V = 1024 and 17,408 visits of one 1024-ray tile; k =
     16,384 and 131,072 copies) in turns: ns a visit and a triangle slot,
     ns a copy and the latency the prefetch hides.

Each full-size run, and each run of phases 3b, 10c, 10d and 15's entry
points, resets the launch counts just before it and reads them just after
(the headline frame must launch no mx kernel, and no frame a probe's).
Every kernel's record carries its bound: the larger of its FP32
operations (counted from the source and this run's inputs, for the BVH
kernels from the node steps and leaf slots its counters report) over 67
TFLOP/s and its bytes (inputs read once, outputs written once; of a BVH's
tables only the distinct node rows and leaf triangle rows this run's rays
read; K15: the bytes it copies) over 3.35 TB/s. The line before
the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs a CUDA device: without one it
exits non-zero and prints no result. Imports nothing of JAX.
"""

import concurrent.futures
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import typing
from unittest import mock

import numpy as np
import torch

from tpu_pathtracer_torch import native
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine import wavefront as wf
from tpu_pathtracer_torch.engine.regen import (_pool_size,
                                               render_image_regen,
                                               render_regen)
from tpu_pathtracer_torch.experiments import dma_probe as dm
from tpu_pathtracer_torch.experiments import dual_probe as dp
from tpu_pathtracer_torch.experiments import iter_ablate as ia
from tpu_pathtracer_torch.experiments import leafmt_probe as lm
from tpu_pathtracer_torch.experiments.common import distinct
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh4 as cb4
from tpu_pathtracer_torch.ops import cuda_bvh_mr as cmr
from tpu_pathtracer_torch.ops import cuda_bvh_mx as cmx
from tpu_pathtracer_torch.ops import cuda_bvh_rg as crg
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
# bvh_mx.cu: a slot's 19 G splits (3 operations each at 3 passes, 5 at
# 6), 19 x passes products and sums, 4 combined sums (2 or 5 adds each),
# f, t, u, v and u + v; a ray's F: 9 operations and 10 three-part splits
MX_SLOT_FLOPS = {3: 19 * 3 + 19 * 3 * 2 + 4 * 2 + 5,
                 6: 19 * 5 + 19 * 6 * 2 + 4 * 5 + 5}
MX_RAY_FLOPS = 9 + 10 * 5
# spheres_mx.cu: a pair's two split products (3 passes of 3 products and
# 2 sums, 2 pass sums: 17 each) and b, c, disc, sqrt, the roots (10); a
# ray's o.d and |o|^2 (5 each) and its 6 values' splits (3 each)
MX_SPHERE_FLOPS, MX_SPHERE_RAY_FLOPS = 2 * 17 + 10, 2 * 5 + 6 * 3
# K2 against K1 on the headline's lanes: the share of lanes whose winner
# agrees. The JAX bound is 0.999 (tests/test_fast_math.py:55), measured
# there with exact f32 products (C-15). With the split an NVIDIA H100
# 80GB HBM3 (700 W) reads 0.99794 on all 960,000 primary lanes and
# 0.99917 on all 811,193 bounce-2 lanes (the same in two runs), so 0.999
# fails on the split's own departures; 0.995 allows 2.4x the departures
# of the worse reading. Each departing lane must also be one the split's
# error can flip (cuda_spheres.mx_error).
MX_AGREE = 0.995
MX_T_REL = 5e-3  # tests/test_fast_math.py:59, plus the split's error
TRI_ROW_BYTES = 48  # a [T, 12] f32 triangle row: v0, e1, e2, n
MX_ROW_BYTES = 4 * cmx.G_COLUMNS  # a [T, 20] f32 test-column row
FAST_DELTA = 2.0 ** -20  # fast_math: the bound on t and on accept flips
# K10 against the exact K5: the share of the hits whose winner may
# differ (2048-lane patches of the dragon's tessellation on the CPU read
# 0.4-1.1% at 3 passes and at most 0.1% at 6, tests/test_torch_bvh_mx.py;
# the dragon's 131,072 lanes 0.46-0.50% and 0.016-0.027%, PERF.md)
MX_DEPART = {3: 0.05, 6: 0.005}
NO_LIBRARY = None  # no single PyTorch call computes these hits
OPS = "tpu_pathtracer/ops/"  # where the JAX package's TPU kernels live
DRAGON_KNOBS = (  # (setting, bound against the default dragon frame)
    # K7's knobs only schedule the TPU's packets: the port computes them
    # with K5/K6, so this frame checks the config's plumbing (the knobs
    # reach the engine and leave the route and the image as they are),
    # not a kernel
    (dict(packet_packs=2, packet_split=True), "bit-identical"),
    (dict(regroup=True), "rmse < 1e-4 (tests/test_packet_rg.py:150)"),
    (dict(fast_math=True), "SSIM >= 0.999 (config.py:250-252)"),
    # the JAX package has no test of this path: the golden's SSIM bound
    # tightened tenfold, and rmse at MX_FRAME_RMSE
    (dict(mx_leaf=True), "SSIM >= 0.999 and rmse < 2e-3"),
)
# mx_leaf's frame against the default one. Its split-bf16 test departs
# from the exact walk on ~0.5% of the hits (phase 10), near an edge or at
# grazing incidence, as the JAX kernel does (tests/test_torch_bvh_mx.py),
# and a path through a crack changes its pixel a lot: three 4-sample
# windows of the frame read 7.8e-4 to 9.7e-4 (PERF.md). The bound leaves
# twice that, so a change that reshuffles which paths meet a crack stays
# under it; doubling the rmse takes about four times the departures,
# which phase 10 bounds at 10x the reading.
MX_FRAME_RMSE = 2e-3


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
    """A kernel's JSON record; ``replaces`` is the TPU kernel's path in
    the repo and its line."""
    return {"name": name, "route": "cuda",
            "source": f"tpu_pathtracer_torch/csrc/{source}",
            "replaces": replaces,
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
    """Build the kernels and the BVH builder side by side."""
    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        return out, time.perf_counter() - t0

    names = ("spheres", "spheres_mx", "tris", "bvh", "bvh4", "bvh_mx",
             "bvh_rg", "bvh_mr", "iter_ablate", "leafmt_probe", "dma_probe",
             "dual_probe")
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as ex:
        futs = {name: ex.submit(timed, _build.build, name)
                for name in names}
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


def sub(v, lanes):
    return V3(*(c[lanes] for c in v))


def mx_pairs_tested(origin, direction, view, eps, t_max):
    """Ray-sphere pairs K3 tests on these rays: up to and including the
    first valid slot, all of them without one."""
    tab = cs.mx_sphere_table(view.sph_c, view.sph_r)
    n, s = origin.x.shape[0], tab.shape[0]
    tested = torch.full((n,), s, dtype=torch.int64, device=tab.device)
    found = torch.zeros((n,), dtype=torch.bool, device=tab.device)
    for base in range(0, s, cs.S_CHUNK):
        ok = cs._mx_sphere_ts(origin, direction, tab[base:base + cs.S_CHUNK],
                              eps, t_max) < FLT_MAX
        has = ok.any(dim=1)
        first = ok.to(torch.uint8).argmax(dim=1)
        tested = torch.where(has & ~found, base + first + 1, tested)
        found = found | has
    return int(tested.sum())


def mx_against_exact(tag, origin, direction, view, eps, mx_out, occ_mx,
                     t_any):
    """K2 against K1 and K3 against K1c on one ray set: winners agree on
    more than MX_AGREE of the lanes, and each departing lane is one the
    split's error can flip (its winner under either form near a root's
    bound, or the two winners' t within their errors); where the winners
    agree, the features are equal and t is within MX_T_REL relative plus
    the split's error, or the sphere has a root within that error of t_min
    (the other root may win). Any-hit agrees on more than 0.999 of the lanes
    (the JAX bound, tests/test_fast_math.py:71). Returns a text."""
    sph = (view.sph_c, view.sph_r)
    tk, ik, fk = mx_out
    te, ie, fe = cs.spheres_hit_feat(origin, direction, *sph, view.sph_feat,
                                     eps, FLT_MAX)
    n = ik.numel()
    dep = (ik != ie).nonzero().flatten()
    if dep.numel() >= (1.0 - MX_AGREE) * n:
        raise AssertionError(f"{tag}: K2's winner departs from K1's on "
                             f"{dep.numel()} of {n} lanes")
    o, d = sub(origin, dep), sub(direction, dep)
    dt_k, flip_k = cs.mx_error(o, d, *sph, ik[dep], eps)
    dt_e, flip_e = cs.mx_error(o, d, *sph, ie[dep], eps)
    tie = ((ik[dep] >= 0) & (ie[dep] >= 0)
           & ((tk[dep] - te[dep]).double().abs() <= 2.0 * (dt_k + dt_e)))
    if not bool((flip_k | flip_e | tie).all()):
        raise AssertionError(f"{tag}: K2 departs from K1 on a lane the "
                             "split's error cannot explain")
    same = (ik == ie) & (ie >= 0)
    dt, flip = cs.mx_error(origin, direction, *sph, ik, eps)
    gap = (tk - te).double().abs()
    if bool((same & ~flip & (gap > MX_T_REL * te.double() + dt)).any()):
        raise AssertionError(f"{tag}: K2's t leaves K1's beyond 5e-3 "
                             "relative plus the split's error")
    past_rel = int((same & (gap > MX_T_REL * te.double())).sum())
    root_flips = int((same & flip & (gap > MX_T_REL * te.double() + dt))
                     .sum())
    if not torch.equal(torch.stack(fk)[:, same], torch.stack(fe)[:, same]):
        raise AssertionError(f"{tag}: features differ where K2 and K1 "
                             "agree")
    occ_e = cs.spheres_anyhit_soa(origin, direction, *sph, eps, t_any)
    occ_dep = int((occ_mx != occ_e).sum())
    if occ_dep >= 1e-3 * n:
        raise AssertionError(f"{tag}: K3's occlusion departs from K1c's on "
                             f"{occ_dep} of {n} lanes")
    near = flip_k | flip_e
    return (f"K2 vs K1: winners agree on {n - dep.numel()}/{n} lanes "
            f"({dep.numel()} depart: {int(near.sum())} with a winner near "
            f"a root's bound or grazing, {int((tie & ~near).sum())} near "
            f"ties), t beyond 5e-3 "
            f"relative on {past_rel} agreeing lanes (within the split's "
            f"error, or the other root of a sphere with a root near t_min: "
            f"{root_flips}); K3 vs K1c: "
            f"occlusion agrees on {n - occ_dep}/{n} lanes "
            f"({int(occ_e.sum())} occluded)")


def mx_path(sets, view, eps):
    """Phase 3b: the mx entry points (K2, K3) on the headline's ray sets
    (name: (origin, direction)), the launch counts set to 0 just before
    and read just after; each against its plain version (bit-equal, also
    on any-hit t_max just past the plain hit), against K1 and K1c
    (``mx_against_exact``), and in turns with them. Returns the JSON
    records of K2 and K3 (times and bounds from the primary set)."""
    sph = (view.sph_c, view.sph_r)
    t_any = {}
    for name, (o, d) in sets.items():
        # any-hit t_max: half the exact hit on odd lanes, FLT_MAX else
        t1, i1 = cs.spheres_hit_soa(o, d, *sph, eps, FLT_MAX)
        odd = torch.arange(t1.numel(), device=t1.device) % 2 == 1
        t_any[name] = torch.where((i1 >= 0) & odd, 0.5 * t1,
                                  FLT_MAX).contiguous()
    torch.cuda.synchronize()
    for key in cs.MX_LAUNCHES:
        cs.MX_LAUNCHES[key] = 0
    outs = {name: (cs.spheres_hit_feat(o, d, *sph, view.sph_feat, eps,
                                       FLT_MAX, mx=True),
                   cs.spheres_anyhit_soa(o, d, *sph, eps, t_any[name],
                                         mx=True))
            for name, (o, d) in sets.items()}
    torch.cuda.synchronize()
    launches = dict(cs.MX_LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the mx path launched {launches}")
    recs = {}
    for name, (o, d) in sets.items():
        tag = f"spheres mx {name}"
        (tk, ik, fk), occ = outs[name]
        tp, ip, fp = cs._spheres_hit_feat_ref(o, d, *sph, view.sph_feat, eps,
                                              FLT_MAX, mx=True)
        if not (torch.equal(ik, ip) and torch.equal(tk, tp)
                and torch.equal(torch.stack(fk), torch.stack(fp))):
            raise AssertionError(f"{tag}: K2 differs from its plain version "
                                 f"on {int((ik != ip).sum())} winners, "
                                 f"{int((tk != tp).sum())} t")
        odd = torch.arange(tp.numel(), device=tp.device) % 2 == 1
        edge = torch.where(ip >= 0, tp * torch.where(odd, 0.5, 1.001),
                           FLT_MAX)
        for tm, o_k in ((t_any[name], occ),
                        (edge, cs.spheres_anyhit_soa(o, d, *sph, eps, edge,
                                                     mx=True))):
            o_p = cs._spheres_anyhit_ref(o, d, *sph, eps, tm, mx=True)
            if not torch.equal(o_k, o_p):
                raise AssertionError(f"{tag}: K3 differs from its plain "
                                     f"version on "
                                     f"{int((o_k != o_p).sum())} lanes")
        text = mx_against_exact(tag, o, d, view, eps, (tk, ik, fk), occ,
                                t_any[name])
        k1 = lambda: cs.spheres_hit_feat(o, d, *sph, view.sph_feat, eps,
                                         FLT_MAX)
        k2 = lambda: cs.spheres_hit_feat(o, d, *sph, view.sph_feat, eps,
                                         FLT_MAX, mx=True)
        k1c = lambda: cs.spheres_anyhit_soa(o, d, *sph, eps, t_any[name])
        k3 = lambda: cs.spheres_anyhit_soa(o, d, *sph, eps, t_any[name],
                                           mx=True)
        turns = [cuda_ms(f) for f in (k1, k2, k2, k1)]
        turns_any = [cuda_ms(f) for f in (k1c, k3, k3, k1c)]
        plain = cuda_ms(lambda: cs._spheres_hit_feat_ref(
            o, d, *sph, view.sph_feat, eps, FLT_MAX, mx=True), reps=2)
        plain_any = cuda_ms(lambda: cs._spheres_anyhit_ref(
            o, d, *sph, eps, t_any[name], mx=True), reps=2)
        n, s = o.x.shape[0], view.sph_r.shape[0]
        bnd = bound(n * (s * MX_SPHERE_FLOPS + MX_SPHERE_RAY_FLOPS),
                    n * (28 + 8 + 72) + s * (32 + 72))
        pairs = mx_pairs_tested(o, d, view, eps,
                                cs._tmax_vector(t_any[name], n, o.x))
        bnd_any = bound(pairs * MX_SPHERE_FLOPS + n * MX_SPHERE_RAY_FLOPS,
                        n * 29 + s * 32)
        phase("kernel", f"{tag}: {n} rays x {s} spheres: K2 and K3 "
              f"bit-equal to their plain versions; {text}; in turns K1 "
              f"{turns[0]:.3f}, K2 {turns[1]:.3f}, K2 {turns[2]:.3f}, K1 "
              f"{turns[3]:.3f} ms (plain K2 {plain:.3f} ms, bound "
              f"{bnd[0]:.4f} ms by {bnd[1]}); K1c {turns_any[0]:.3f}, K3 "
              f"{turns_any[1]:.3f}, K3 {turns_any[2]:.3f}, K1c "
              f"{turns_any[3]:.3f} ms (plain K3 {plain_any:.3f} ms, "
              f"{pairs} pairs tested, bound {bnd_any[0]:.4f} ms by "
              f"{bnd_any[1]})")
        err = (tk - tp).abs().max().item()
        recs.setdefault("spheres_mx_feat", record(
            "spheres_mx_feat", "spheres_mx.cu",
            OPS + "pallas_spheres.py:271", launches["features"], err,
            (turns[1] + turns[2]) / 2, plain, bnd))
        recs.setdefault("spheres_mx_anyhit", record(
            "spheres_mx_anyhit", "spheres_mx.cu",
            OPS + "pallas_spheres.py:499", launches["any_hit"], 0.0,
            (turns_any[1] + turns_any[2]) / 2, plain_any, bnd_any))
    phase("kernel", f"spheres mx path: launches {launches}")
    return list(recs.values())


def spheres_path(dev):
    """Phases 3-5 and 3b. Returns the JSON records of K1, K2 and K3."""
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
    mx_recs = mx_path({"primary": (o1, d1), "bounce-2": (o2, d2)}, view,
                      cfg.epsilon)

    scfg = RenderConfig(**SMALL)
    sscene, scam = random_spheres_scene(scfg.nx, scfg.ny, device=dev)
    small_renders("spheres", sscene, scam, scfg,
                  [(cs, "spheres_hit_feat", cs._spheres_hit_feat_ref)])

    render_image_regen(scene, cam, cfg, ns=1)  # warm-up
    cs.LAUNCHES = 0
    for key in cs.MX_LAUNCHES:
        cs.MX_LAUNCHES[key] = 0
    reset_launches()
    img, secs, wall = render_timed(lambda: render_image_regen(scene, cam,
                                                              cfg))
    launches = cs.LAUNCHES
    if launches <= 0:
        raise AssertionError("the headline render launched no sphere kernel")
    if sum(cs.MX_LAUNCHES.values()) or read_launches():
        raise AssertionError(f"the headline render launched the mx kernel "
                             f"{cs.MX_LAUNCHES} or {read_launches()}")
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
    return [record("spheres_hit_feat", "spheres.cu",
                   OPS + "pallas_spheres.py:73", launches, max(err1, err2),
                   ms, plain_ms, bnd), *mx_recs]


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
    reset_launches()
    (fb, iters), secs, wall = render_timed(
        lambda: render_regen(scene, cam, cfg, return_iters=True))
    launches = dict(ct.LAUNCHES)
    if launches["features"] <= 0 or launches["any_hit"] <= 0:
        raise AssertionError(f"the staircase render launched the nearest "
                             f"and any-hit kernels {launches} times")
    others = set(read_launches()) - {"cuda_tris.features",
                                     "cuda_tris.any_hit"}
    if others:
        raise AssertionError(f"the staircase render launched {others}")
    img = fb.cpu().numpy().reshape(cfg.ny, cfg.nx, 3)
    r8, s8 = gate_crop("staircase", img, STAIR_GOLDEN)
    paths = cfg.num_pixels * cfg.ns
    phase("staircase", f"{cfg.nx}x{cfg.ny} {cfg.ns} spp depth "
          f"{cfg.max_depth}: {secs:.3f} s (CUDA events; host wall "
          f"{wall:.3f} s), {paths / secs / 1e6:.3f} Mpaths/s, {iters} "
          f"regen iterations, kernel launches {launches}, mean "
          f"{img.mean():.4f}; crop vs TPU golden rmse {r8:.3e} "
          f"ssim {s8:.6f}")
    return [record("tris_hit_feat", "tris.cu", OPS + "pallas_tris.py:77",
                   launches["features"], max(err1, err2), ms, plain_ms,
                   bnd),
            record("tris_anyhit_soa", "tris.cu", OPS + "pallas_tris.py:77",
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


def _rg_walk(origin, direction, t_max, tabs, eps, any_hit, visits):
    """regroup's plain walk: K11's rounds for nearest hits, K6's walk for
    shadow rays, as the engine sends them."""
    if any_hit:
        return cb._heap_walk_ref(origin, direction, t_max, tabs, eps, True,
                                 visits)
    t, tri, cnt = crg._rg_walk_ref(origin, direction, t_max, tabs, eps,
                                   visits)
    return t, tri, None, cnt


class Route(typing.NamedTuple):
    """A ``wf.mesh_tier`` route: its nearest and any-hit wrappers
    ((module, name); the plain version is the module's ``_<name>_ref``),
    its plain walk, and its cost model: the leaf slots of a table, slab
    tests a node step, bytes of a node row and of a leaf slot, FP32
    operations of a leaf slot and of a ray's set-up."""
    nearest: tuple
    any_hit: tuple
    walk: typing.Callable
    slots: typing.Callable
    slabs: int
    node_bytes: int
    row_bytes: int
    slot_flops: int
    ray_flops: int


HEAP_NODE = 6 * 4  # one child box (min, max)
ROUTES = {
    "bvh4": Route((cb4, "bvh4_trace"), (cb4, "bvh4_occluded"),
                  cb4._bvh4_walk_ref, lambda tabs: tabs.width, 4,
                  4 * (6 * 4 + 4), TRI_ROW_BYTES, MT_FLOPS, 3),
    "heap": Route((cb, "heap_trace"), (cb, "heap_occluded"),
                  cb._heap_walk_ref, lambda tabs: tabs.prims_per_leaf, 2,
                  HEAP_NODE, TRI_ROW_BYTES, MT_FLOPS, 3),
    # at mx_passes = 3, the config's default
    "heap-mx": Route((cmx, "mx_trace"), (cmx, "mx_occluded"),
                     functools.partial(cmx._mx_walk_ref, passes=3),
                     lambda tabs: tabs.heap.prims_per_leaf, 2, HEAP_NODE,
                     MX_ROW_BYTES, MX_SLOT_FLOPS[3], 3 + MX_RAY_FLOPS),
    # shadow rays under regroup take K6
    "heap-rg": Route((crg, "rg_trace"), (cb, "heap_occluded"), _rg_walk,
                     lambda tabs: tabs.prims_per_leaf, 2, HEAP_NODE,
                     TRI_ROW_BYTES, MT_FLOPS, 3),
}


class BvhKernels:
    """The wrappers of one BVH route (``ROUTES``) on one set of tables,
    their plain versions and the route's cost model."""

    def __init__(self, route, tabs):
        self.tier, self.tabs, self.route = route, tabs, ROUTES[route]
        (mod, name), (amod, aname) = self.route.nearest, self.route.any_hit
        self.trace = getattr(mod, name)
        self.trace_ref = getattr(mod, f"_{name}_ref")
        self.occluded = getattr(amod, aname)
        self.occluded_ref = getattr(amod, f"_{aname}_ref")
        self.slots = self.route.slots(tabs)

    def plain(self):
        """Patches that send the engine through the plain versions."""
        return [(mod, name, getattr(mod, f"_{name}_ref"))
                for mod, name in (self.route.nearest, self.route.any_hit)]

    def walk_plain(self, origin, direction, t_max, eps, any_hit):
        """The plain walk, and the distinct node rows and leaves it read.
        Returns (t, tri, occ, counters, nodes read, leaves read)."""
        visits = {"nodes": [], "leaves": []}
        out = self.route.walk(origin, direction, t_max, self.tabs, eps,
                              any_hit=any_hit, visits=visits)
        return (*out, distinct(visits["nodes"]), distinct(visits["leaves"]))

    def table_bytes(self, nodes, leaves):
        """Bytes of the distinct table rows a walk needs, each read
        once."""
        return (nodes * self.route.node_bytes
                + leaves * self.slots * self.route.row_bytes)

    def nearest_flops(self, n, cnt):
        c = cnt.sum(dim=1, dtype=torch.int64)
        r = self.route
        return (r.ray_flops * n + int(c[4]) * r.slabs * SLAB_FLOPS
                + int(c[2]) * self.slots * r.slot_flops)

    def anyhit_flops(self, n, cnt, occ, best):
        """As nearest, but the last visit of an occluded ray tests only
        the slots up to its first hit."""
        c = cnt.sum(dim=1, dtype=torch.int64)
        r = self.route
        last = int((best[occ].to(torch.int64) % self.slots + 1).sum())
        slots = (int(c[2]) - int(occ.sum())) * self.slots + last
        return (r.ray_flops * n + int(c[4]) * r.slabs * SLAB_FLOPS
                + slots * r.slot_flops)


def compare_bvh_nearest(tag, kern, origin, direction, t_max, eps):
    """A BVH tier's nearest-hit kernel against its plain version: t
    bit-equal, winners equal except exact ties (K10 and K11, which merge
    in their plain versions' order: no exception), per-ray counters
    equal.
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
    ties = i_k.numel() // 1000 if kern.tier in ("bvh4", "heap") else 0
    if bool((mism & ((i_k < 0) | (i_p < 0))).any()) or \
            int(mism.sum()) > ties:
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
    plain_ms, bound) of nearest and of any-hit, and the three ray sets
    (name: (origin, direction, t_max))."""
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
    rays = {"primary": (o1, d1, torch.full((BVH_RAYS,), FLT_MAX,
                                           device=dev)),
            "bounce-2": (o2, d2, t2), "NEE shadows": shadow}
    return near, anyh, rays


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
    (err, ms, plain_ms, bnd), (err_a, ms_a, plain_a, bnd_a), _ = \
        bvh_kernel_phase("bvh4 staircase-hires", scene, cam, cfg, kern)

    scfg = RenderConfig(**SMALL)
    sscene, scam = procedural_staircase_scene(scfg.nx, scfg.ny, device=dev,
                                              **HIRES)
    img4 = small_renders("staircase-hires", sscene, scam, scfg,
                         kern.plain())
    for key in cb.LAUNCHES:
        cb.LAUNCHES[key] = 0
    img_h = render_image_regen(sscene, scam, scfg.replace(bvh4=False))
    if min(cb.LAUNCHES["nearest"], cb.LAUNCHES["any_hit"]) <= 0:
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
    reset_launches()
    (fb, iters), secs, wall = render_timed(
        lambda: render_regen(scene, cam, cfg, return_iters=True))
    ran = read_launches()
    if set(ran) != {"cuda_bvh4.nearest", "cuda_bvh4.any_hit"}:
        raise AssertionError(f"config 4 launched {ran}: the BVH4 kernels "
                             "alone should run")
    launches = dict(cb4.LAUNCHES)
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
    return [record("bvh4_trace", "bvh4.cu", OPS + "pallas_bvh4.py:295",
                   launches["nearest"], err, ms, plain_ms, bnd),
            record("bvh4_occluded", "bvh4.cu", OPS + "pallas_bvh4.py:598",
                   launches["any_hit"], err_a, ms_a, plain_a, bnd_a)]


TRI_MODULES = (cb4, cb, ct, cmx, crg, cmr)
PROBE_MODULES = (ia, lm, dm, dp)  # K13-K16: on no frame's path


def reset_launches(mods=TRI_MODULES + PROBE_MODULES):
    for mod in mods:
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0


def read_launches(mods=TRI_MODULES + PROBE_MODULES):
    """{"module.mode": launches} of every triangle or probe kernel that
    ran."""
    return {f"{mod.__name__.rsplit('.', 1)[1]}.{key}": count
            for mod in mods for key, count in mod.LAUNCHES.items()
            if count}


def near_accept_bound(tab64, o, d, t_min, t_hi):
    """True if some triangle (rows of ``tab64``, [T, 12] float64: v0, e1,
    e2, n) is accepted for the ray ``o``, ``d`` ([3] float64) in (t_min,
    t_hi) to within FAST_DELTA and has its exact u, v, u + v, t or |a|
    within FAST_DELTA of an accept bound: a lane whose outcome a reciprocal
    off by an ulp may flip."""
    v0, e1, e2, n = (tab64[:, 0:3], tab64[:, 3:6], tab64[:, 6:9],
                     tab64[:, 9:12])
    a = -(n @ d)
    s = o - v0
    q = torch.linalg.cross(s, d.expand_as(s))
    u = (q * e2).sum(1) / a
    v = -(q * e1).sum(1) / a
    t = (s * n).sum(1) / a
    dl = FAST_DELTA
    inside = ((a.abs() >= 1e-7 * (1 - dl)) & (u >= -dl) & (v >= -dl)
              & (u + v <= 1 + dl) & (t > t_min * (1 - dl))
              & (t < t_hi * (1 + dl)))
    edge = ((u.abs() <= dl) | (v.abs() <= dl) | ((u + v - 1).abs() <= dl)
            | ((t - t_min).abs() <= dl * t_min)
            | ((t - t_hi).abs() <= dl * abs(t_hi))
            | ((a.abs() - 1e-7).abs() <= dl * 1e-7))
    return bool((inside & edge).any())


def compare_fast_math(tag, kern, origin, direction, t_max, eps, any_hit):
    """K5 (nearest) or K6 (``any_hit``) in fast_math mode against the
    plain walk, which keeps the exact division: where the winners agree, t
    within 2^-20 relative; winners, hits and occlusion equal except on
    lanes near an accept bound (``near_accept_bound``), which are
    counted. Returns (max |t|
    error, or the lanes whose occlusion differs; kernel ms, plain ms,
    bound)."""
    tabs = kern.tabs
    n = origin.x.shape[0]
    args = (origin, direction, t_max, tabs, eps)
    fast = lambda: (cb.heap_occluded if any_hit else cb.heap_trace)(
        *args, approx_recip=True)
    plain = cb._heap_occluded_ref if any_hit else cb._heap_trace_ref
    k = fast()
    t_p, i_p, o_p, c_p, nodes, leaves = kern.walk_plain(
        origin, direction, t_max, eps, any_hit)
    torch.cuda.synchronize()
    if any_hit:
        differ = (k[0] != o_p).nonzero().flatten()
        t_hi, err = t_max, float(differ.numel())
        what = f"occ equal except on {differ.numel()} lanes"
    else:
        t_k, i_k, _ = k
        differ = (i_k != i_p).nonzero().flatten()
        same = (i_k == i_p) & (i_p >= 0)
        dt = (t_k - t_p)[same].abs()
        if bool((dt > FAST_DELTA * t_p[same].abs()).any()):
            raise AssertionError(f"{tag}: t off by {dt.max().item():.3e}")
        t_hi, err = t_p, dt.max().item() if dt.numel() else 0.0
        what = (f"winners equal except on {differ.numel()} lanes, t within "
                f"2^-20 (max |err| {err:.3e})")
    if differ.numel() > 256:
        raise AssertionError(f"{tag}: {differ.numel()} lanes differ")
    tab64 = tabs.tri.double()
    for j in differ.tolist():
        o = torch.stack([c[j] for c in origin]).double()
        d = torch.stack([c[j] for c in direction]).double()
        if not near_accept_bound(tab64, o, d, eps, float(t_hi[j])):
            raise AssertionError(f"{tag}: lane {j} differs with no "
                                 "triangle near an accept bound")
    # the exact and fast_math modes in turns on the same lanes
    exact = lambda: (cb.heap_occluded if any_hit else cb.heap_trace)(*args)
    turns = [cuda_ms(f) for f in (exact, fast, fast, exact)]
    ms = (turns[1] + turns[2]) / 2
    plain_ms = cuda_ms(lambda: plain(*args), reps=2)
    if any_hit:
        bnd = bound(kern.anyhit_flops(n, c_p, o_p, i_p),
                    n * (28 + 1 + 20) + kern.table_bytes(nodes, leaves))
    else:
        bnd = bound(kern.nearest_flops(n, c_p),
                    n * (28 + 8 + 20) + kern.table_bytes(nodes, leaves))
    phase("kernel", f"{tag}: {n} lanes ({int((t_max > 0).sum())} live): "
          f"{what}, each such lane with a triangle within 2^-20 of an "
          f"accept bound; kernel {ms:.3f} ms vs plain (exact) "
          f"{plain_ms:.3f} ms (bound {bnd[0]:.4f} ms by {bnd[1]}); in "
          f"turns exact {turns[0]:.3f}, fast_math {turns[1]:.3f}, "
          f"fast_math {turns[2]:.3f}, exact {turns[3]:.3f} ms")
    return err, ms, plain_ms, bnd


def edge_and_incidence(heap, origin, direction, ids):
    """Of each ray's hit point on heap slot ``ids`` [L], exactly (float64):
    its barycentric distance to the triangle's nearest edge,
    |min(u, v, 1 - u - v)|, and the cosine of the ray's incidence,
    |a| / |n|. The split-bf16 test errs by about its numerators' rounding
    over |a|, so it misjudges hits near an edge or at grazing incidence."""
    rows = heap.tri[ids].double()
    v0, e1, e2, n = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    o = torch.stack(list(origin), 1).double()
    d = torch.stack(list(direction), 1).double()
    a = -(n * d).sum(1)
    q = torch.linalg.cross(o - v0, d)
    u = (q * e2).sum(1) / a
    v = -(q * e1).sum(1) / a
    edge = torch.minimum(torch.minimum(u, v), 1.0 - u - v).abs()
    return edge, a.abs() / n.norm(dim=1)


def mx_departures(tag, mesh, mx_tabs, origin, direction, t_max, eps):
    """Where K10's split-bf16 leaf test departs from the exact K5 on these
    lanes, at 3 and 6 passes: the lanes whose winner is a neighbour of
    K5's (shares a vertex), the pass-throughs (K5 hits, K10 misses or hits
    a triangle that is no neighbour) and the extra hits (K10 hits, K5
    misses), at most MX_DEPART[passes] of the hits; with the median edge
    distance and incidence cosine of those lanes' exact winners (K10's
    where K5 misses) against all hits'. Returns {passes: (neighbour,
    through, extra)}."""
    heap = mx_tabs.heap
    _, i5, _ = cb.heap_trace(origin, direction, t_max, heap, eps)
    hits = int((i5 >= 0).sum())
    verts = torch.stack([mesh.v0, mesh.v1, mesh.v2], 1)  # [T, 3, 3]

    def medians(lanes, ids):
        if lanes.numel() == 0:
            return "-"
        edge, cos = edge_and_incidence(
            heap, V3(*(c[lanes] for c in origin)),
            V3(*(c[lanes] for c in direction)), ids.long())
        return f"{edge.median().item():.4f}, {cos.median().item():.3f}"

    lanes = (i5 >= 0).nonzero().flatten()
    out, parts = {}, [f"all hits {medians(lanes, i5[lanes])}"]
    for passes in cmx.PASSES:
        _, i10, _ = cmx.mx_trace(origin, direction, t_max, mx_tabs, eps,
                                 passes)
        lanes = (i10 != i5).nonzero().flatten()
        a, b = i5[lanes].long(), i10[lanes].long()
        va, vb = verts[a.clamp_min(0)], verts[b.clamp_min(0)]
        near = ((a >= 0) & (b >= 0)
                & (va[:, :, None] == vb[:, None]).all(-1).any(-1).any(-1))
        counts = (int(near.sum()), int(((a >= 0) & ~near).sum()),
                  int((a < 0).sum()))
        if lanes.numel() > MX_DEPART[passes] * hits:
            raise AssertionError(
                f"{tag} at {passes} passes: {lanes.numel()} lanes of {hits} "
                f"hits depart from K5 (bound {MX_DEPART[passes]:.2%})")
        out[passes] = counts
        parts.append(f"{passes} passes: {counts[0]} neighbour winners, "
                     f"{counts[1]} pass-throughs, {counts[2]} extra hits "
                     f"({lanes.numel() / max(hits, 1):.3%} of the hits; "
                     f"{medians(lanes, torch.where(a >= 0, a, b))})")
    phase("kernel", f"{tag}: K10 against K5 on {hits} hits of "
          f"{i5.numel()} lanes (median edge distance, incidence cosine): "
          + "; ".join(parts))
    return out


def heap_variants_phase(mesh, tabs, rays, eps):
    """Phase 10's second half: the heap tier's other kernels on the same
    lanes. Returns {record name: (err, ms, plain_ms, bound)}, the nearest
    modes' from the primary rays."""
    out = {}
    o1, d1, t1 = rays["primary"]
    o2, d2, t2 = rays["bounce-2"]
    shadow = rays["NEE shadows"]
    mx_tabs = cmx.mx_tables(mesh)
    mx = BvhKernels("heap-mx", mx_tabs)
    out["mx_trace"] = compare_bvh_nearest("heap-mx dragon primary", mx, o1,
                                          d1, t1, eps)
    compare_bvh_nearest("heap-mx dragon bounce-2", mx, o2, d2, t2, eps)
    out["mx_occluded"] = compare_bvh_anyhit("heap-mx dragon NEE shadows",
                                            mx, *shadow, eps)
    for name in ("primary", "bounce-2"):
        mx_departures(f"heap-mx dragon {name}", mesh, mx_tabs, *rays[name],
                      eps)
    occ6 = cb.heap_occluded(*shadow, tabs, eps)[0]
    flips = {p: int((cmx.mx_occluded(*shadow, mx_tabs, eps, p)[0]
                     != occ6).sum()) for p in cmx.PASSES}
    phase("kernel", f"heap-mx dragon NEE shadows: K10b's occlusion differs "
          f"from K6's on {flips[3]} lanes at 3 passes, {flips[6]} at 6, of "
          f"{int((shadow[2] > 0).sum())} shadow rays")
    rg = BvhKernels("heap-rg", tabs)
    out["rg_trace"] = compare_bvh_nearest("heap-rg dragon primary", rg, o1,
                                          d1, t1, eps)
    compare_bvh_nearest("heap-rg dragon bounce-2", rg, o2, d2, t2, eps)
    for name, (o, d, t) in (("primary", rays["primary"]),
                            ("bounce-2", rays["bounce-2"])):
        v5 = int(cb.heap_trace(o, d, t, tabs, eps)[2][2].sum())
        ratio = int(crg.rg_trace(o, d, t, tabs, eps)[2][2].sum()) / max(v5,
                                                                        1)
        if not 1.0 <= ratio <= 1.5:
            raise AssertionError(f"heap-rg dragon {name}: K11's leaf visits "
                                 f"are {ratio:.3f}x K5's, outside [1, 1.5]")
        # K5 and K11 in turns on the same lanes
        k5 = lambda: cb.heap_trace(o, d, t, tabs, eps)
        k11 = lambda: crg.rg_trace(o, d, t, tabs, eps)
        turns = [cuda_ms(f) for f in (k5, k11, k11, k5)]
        phase("kernel", f"heap-rg dragon {name}: K11's leaf visits "
              f"{ratio:.3f}x K5's {v5} (window {crg.WINDOW}; bound 1.5x); in "
              f"turns K5 {turns[0]:.3f} ms, K11 {turns[1]:.3f} ms, K11 "
              f"{turns[2]:.3f} ms, K5 {turns[3]:.3f} ms")
    heap = BvhKernels("heap", tabs)
    out["heap_trace_fast_math"] = compare_fast_math(
        "fast_math dragon primary", heap, o1, d1, t1, eps, False)
    compare_fast_math("fast_math dragon bounce-2", heap, o2, d2, t2, eps,
                      False)
    out["heap_occluded_fast_math"] = compare_fast_math(
        "fast_math dragon NEE shadows", heap, *shadow, eps, True)
    return out


def mr_phase(tabs, rays, eps, bounds):
    """Phase 10c: the packet walk, K12a (nearest) on the primary rays and
    K12b (any-hit) on their NEE shadow rays, the launch counts set to 0
    just before and read just after; each against its plain version (t,
    winners, features, occlusion and the per-packet counters bit-equal),
    against K5 / K6 (t and occlusion equal, winners equal but on exact
    ties) and in turns with them. The function is K5's / K6's on the same
    lanes, so the bound is theirs (``bounds``: phase 10's (K5, K6)
    bounds, from the per-ray work and distinct rows their walks need).
    The packet walk's own work is printed beside it: 32 lanes x the
    packets' node rounds (two slab tests) and leaf slots, and the
    distinct rows it reads. Returns the JSON records of K12a and K12b."""
    o1, d1, t1 = rays["primary"]
    shadow = rays["NEE shadows"]
    torch.cuda.synchronize()
    for key in cmr.LAUNCHES:
        cmr.LAUNCHES[key] = 0
    near_k, cnt_k = cmr.mr_trace(o1, d1, t1, tabs, eps)
    occ_k, ocnt_k = cmr.mr_occluded(*shadow, tabs, eps)
    torch.cuda.synchronize()
    launches = dict(cmr.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the packet-walk path launched {launches}")
    recs = []
    for any_hit, (o, d, tm) in ((False, (o1, d1, t1)), (True, shadow)):
        tag = f"mr dragon {'NEE shadows' if any_hit else 'primary'}"
        n = o.x.shape[0]
        visits = {"nodes": [], "leaves": []}
        t_p, i_p, occ_p, c_p = cmr._mr_walk_ref(o, d, tm, tabs, eps, any_hit,
                                                visits)
        if any_hit:
            cnt = ocnt_k
            occ6, cnt6 = cb.heap_occluded(o, d, tm, tabs, eps)
            if not (torch.equal(occ_k, occ_p) and torch.equal(cnt, c_p)):
                raise AssertionError(f"{tag}: K12b differs from its plain "
                                     f"version on "
                                     f"{int((occ_k != occ_p).sum())} lanes")
            if not torch.equal(occ_k, occ6):
                raise AssertionError(f"{tag}: K12b's occlusion differs from "
                                     f"K6's on {int((occ_k != occ6).sum())} "
                                     "lanes")
            what = (f"occlusion equal to the plain walk's and K6's "
                    f"({int(occ_k.sum())} occluded of "
                    f"{int((tm > 0).sum())} shadow rays)")
            err = 0.0
            k12 = lambda: cmr.mr_occluded(o, d, tm, tabs, eps)
            k5 = lambda: cb.heap_occluded(o, d, tm, tabs, eps)
            plain = lambda: cmr._mr_occluded_ref(o, d, tm, tabs, eps)
        else:
            cnt, (t_k, i_k) = cnt_k, near_k[:2]
            p_out = cb.winner_features(o, d, t_p, i_p, tabs.tri_feat)
            if not (all(torch.equal(a, b) for a, b in zip(near_k, p_out))
                    and torch.equal(cnt, c_p)):
                raise AssertionError(f"{tag}: K12a differs from its plain "
                                     f"version on "
                                     f"{int((i_k != i_p).sum())} winners, "
                                     f"{int((t_k != t_p).sum())} t")
            t5, i5, cnt6 = cb.heap_trace(o, d, tm, tabs, eps)
            if not torch.equal(t_k, t5):
                raise AssertionError(f"{tag}: K12a's t differs from K5's on "
                                     f"{int((t_k != t5).sum())} lanes")
            # t is equal on every lane, so a winner that differs is a tie
            ties = int((i_k != i5).sum())
            what = (f"t, winners, features and counters equal to the plain "
                    f"walk's; t equal to K5's, winners but {ties} exact "
                    f"ties; hits {int((i_k >= 0).sum())}")
            err = (t_k - t_p).abs().max().item()
            k12 = lambda: cmr.mr_trace(o, d, tm, tabs, eps)
            k5 = lambda: cb.heap_trace(o, d, tm, tabs, eps)
            plain = lambda: cmr._mr_trace_ref(o, d, tm, tabs, eps)
        turns = [cuda_ms(f) for f in (k5, k12, k12, k5)]
        plain_ms = cuda_ms(plain, reps=2)
        rounds = sum(v.numel() for v in visits["nodes"]) // 2
        leaves = int(cnt[2].sum(dtype=torch.int64))
        slots = tabs.prims_per_leaf
        flops = 3 * n + cmr.LANES * (rounds * 2 * SLAB_FLOPS
                                     + leaves * slots * MT_FLOPS)
        nodes, leaves_read = distinct(visits["nodes"]), distinct(
            visits["leaves"])
        walk = bound(flops, n * (28 + (1 if any_hit else 8))
                     + cnt.numel() * 4 + nodes * HEAP_NODE
                     + leaves_read * slots * TRI_ROW_BYTES)
        bnd = bounds[any_hit]
        pk = cnt.double()
        warp = lambda c: c.view(-1, cmr.LANES).max(dim=1).values.double(
            ).mean().item() if n % cmr.LANES == 0 else float("nan")
        s6 = (cnt6[0] + cnt6[1]).double()
        heap, kern = ("K6", "K12b") if any_hit else ("K5", "K12a")
        phase("kernel", f"{tag}: {n} rays in {cnt.shape[1]} packets: "
              f"{what}; per packet {(pk[0] + pk[1]).mean().item():.1f} node "
              f"rounds entering a child ({rounds / cnt.shape[1]:.1f} in "
              f"all), {pk[2].mean().item():.1f} leaf visits; {heap} per ray "
              f"{s6.mean().item():.1f} steps entering a child (warp max "
              f"{warp(cnt6[0] + cnt6[1]):.1f}), "
              f"{cnt6[2].double().mean().item():.1f} leaf visits (warp max "
              f"{warp(cnt6[2]):.1f}); read {nodes} distinct node rows, "
              f"{leaves_read} leaves; in turns {heap} {turns[0]:.3f}, {kern} "
              f"{turns[1]:.3f}, {turns[2]:.3f}, {heap} {turns[3]:.3f} ms "
              f"(plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms by "
              f"{bnd[1]}, {heap}'s; the packet walk's own work "
              f"{walk[0]:.4f} ms by {walk[1]})")
        recs.append(record("mr_occluded" if any_hit else "mr_trace",
                           "bvh_mr.cu", "experiments/pallas_bvh_mr.py:214",
                           launches["any_hit" if any_hit else "nearest"],
                           err, (turns[1] + turns[2]) / 2, plain_ms, bnd))
    return recs


def walk_probe_phase(tabs, rays, eps):
    """Phase 10d: the walk probes on phase 10's primary lanes, the launch
    counts set to 0 just before and read just after. ``iter_ablate`` and
    ``dual_probe``'s ``measure``: K13's modes held bit-equal to their plain
    walks and timed in turns with K5, once with closest held at t_max (no
    culling, as the TPU probe) and once at K5's hit t (a subset of K5's
    visits), the split of each printed; K16 at R = 1, 2, 4 held bit-equal
    to the plain node phase and timed in turns. Bounds from the node steps
    and leaf slots the counters report and the distinct rows the plain
    walks read. Returns the JSON records of K13's three modes (the
    no-culling reading) and K16's three forms."""
    t_phase = time.perf_counter()
    o, d, tm = rays["primary"]
    n = o.x.shape[0]
    torch.cuda.synchronize()
    reset_launches((ia, dp))
    k13 = ia.measure(o, d, tm, tabs, eps, rounds=2)
    k16 = dp.measure(o, d, tabs, rounds=2)
    launches = {**{f"iter_ablate.{k}": v for k, v in k13["launches"].items()},
                **{f"dual_probe.{k}": v for k, v in k16["launches"].items()}}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the walk-probe path launched {launches}")
    P = tabs.prims_per_leaf
    recs = []
    for tag, r in (("closest at t_max, no culling", k13),
                   ("closest at K5's hit t",
                    ia.measure(o, d, tm, tabs, eps, at_k5_hits=True,
                               rounds=2))):
        c = r["counters"]["modes"].sum(dim=1, dtype=torch.int64)
        c5 = r["counters"]["K5"].sum(dim=1, dtype=torch.int64)
        phase("kernel", f"K13 on the dragon's {n} primary rays, {tag}: every "
              f"mode's acc and counters bit-equal to its plain walk; "
              f"{int(c[4])} node steps and {int(c[2])} leaf visits (K5 "
              f"{int(c5[4])} and {int(c5[2])}), {r['nodes']} distinct node "
              f"rows, {r['leaves']} leaves; in turns, 2 rounds: " + ", ".join(
                  f"{m} {r['ms'][m]:.3f} ms (readings "
                  f"{min(r['readings'][m]):.3f}-{max(r['readings'][m]):.3f}, "
                  f"plain {r['plain_ms'][m]:.1f})" for m in ia.MODES)
              + f"; split of full: {ia.split_text(r)}")
    c = k13["counters"]["modes"].sum(dim=1, dtype=torch.int64)
    for m in ia.MODES:
        flops = 3 * n + int(c[4]) * 2 * SLAB_FLOPS
        nbytes = n * (28 + 4 + 20) + k13["nodes"] * HEAP_NODE
        if m != "noleaf":
            nbytes += k13["leaves"] * P * TRI_ROW_BYTES
        if m == "full":
            flops += int(c[2]) * P * MT_FLOPS
        recs.append(record(f"iter_ablate_{m}", "iter_ablate.cu",
                           "experiments/iter_ablate.py:60",
                           launches[f"iter_ablate.{m}"], 0.0, k13["ms"][m],
                           k13["plain_ms"][m], bound(flops, nbytes)))

    total = k16["total"]
    bnd = bound(3 * n + total * 2 * SLAB_FLOPS,
                n * (24 + 4) + k16["nodes"] * HEAP_NODE)
    text = []
    for r in dp.RAYS_PER_THREAD:
        t, readings = k16["ms"][r], k16["readings"][r]
        text.append(f"R={r} {t:.3f} ms ({t * 1e6 / total:.3f} ns a step; "
                    f"readings {min(readings):.3f}-{max(readings):.3f})")
        recs.append(record(f"dual_probe_r{r}", "dual_probe.cu",
                           "experiments/dual_probe.py:37",
                           launches[f"dual_probe.r{r}"], 0.0, t,
                           k16["plain_ms"], bnd))
    phase("kernel", f"K16 dragon primary: {n} rays, {total} interior steps, "
          f"bit-equal to the plain node phase at every R; in turns "
          + ", ".join(text) + f"; plain {k16['plain_ms']:.3f} ms (bound "
          f"{bnd[0]:.4f} ms by {bnd[1]}); launches {launches}; phase 10d "
          f"in {time.perf_counter() - t_phase:.1f} s")
    return recs


def leaf_probe_phase(dev):
    """Phase 15: the leaf-fetch probes on the TPU probes' seeded inputs,
    the launch counts set to 0 just before and read just after.
    ``leafmt_probe`` and ``dma_probe``'s ``measure``: K14's modes on one
    tile, each held bit-equal to its plain version and timed in turns at
    V = 1024 and 17,408 visits, past the 611 clusters' wrap (db2 is
    checked and takes db's times: db's kernel); K15's two
    kernels held bit-equal to the plain in-order sum at k = 16,384 and
    131,072 copies and timed in turns there: the per-visit and per-copy
    slopes. The records' times, plain times and bounds are at the pair's
    lower point. Returns the JSON records of K14's modes and K15's two
    kernels."""
    t_phase = time.perf_counter()
    one = lm.probe_inputs(1, dev)
    blocks = dm.probe_blocks(device=dev)
    torch.cuda.synchronize()
    reset_launches((lm, dm))
    k14 = lm.measure(one, rounds=1)
    k15 = dm.measure(blocks, rounds=1)
    launches = {**{f"leafmt_probe.{k}": v for k, v in k14["launches"].items()},
                **{f"dma_probe.{k}": v for k, v in k15["launches"].items()}}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the leaf-probe path launched {launches}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    recs = []
    lo, hi = lm.VISITS
    text = []
    for m in lm.MODES:
        (t_lo, t_hi), per = k14["t"][m], k14["per_visit"][m]
        plain_ms = k14["plain_ms"][m]
        bnd = bound(MT_FLOPS * lm.WIDTH * lm.TILE * lo,
                    lm.TILE * (28 + 8) + lm.WIDTH * TRI_ROW_BYTES * (
                        1 if m in ("pure", "cond") else min(lo, lm.CLUSTERS)))
        served = lm.SERVED_BY.get(m)
        if not served:
            text.append(f"{m} {per:.1f} ns a visit ({per / lm.WIDTH:.2f} a "
                        f"slot; t({lo}) {t_lo:.3f} ms, t({hi}) {t_hi:.3f} "
                        f"ms, plain t({lo}) {plain_ms:.3f} ms)")
        rec = record(f"leafmt_{m}", "leafmt_probe.cu",
                     "experiments/leafmt_probe.py:36",
                     launches[f"leafmt_probe.{m}"], 0.0, t_lo, plain_ms, bnd)
        if served:
            rec["served_by"] = served
        recs.append(rec)
    phase("kernel", f"K14: {len(lm.MODES)} modes bit-equal to their plain "
          f"versions at {lo} and {hi} visits (db2 is served by db's kernel "
          f"and takes its times); one {lm.TILE}-ray tile on 1 of {sms} SMs, in turns: "
          + "; ".join(text) + f"; bound at V={lo}: {recs[0]['bound_ms']:.4f} "
          f"ms card-wide, by operations")
    lo, hi = dm.COPIES
    per = k15["per_copy"]
    for m, line in zip(dm.MODES, ("experiments/dma_probe.py:36",
                                  "experiments/dma_probe.py:50")):
        recs.append(record(f"dma_{m}", "dma_probe.cu", line,
                           launches[f"dma_probe.{m}"], 0.0, k15["t"][m][0],
                           k15["plain_ms"],
                           bound(lo, lo * 4 * dm.CLUSTER_FLOATS + 4)))
    phase("kernel", f"K15: sync and db equal to the plain in-order sum at "
          f"{lo} and {hi} copies; in turns, " + ", ".join(
              f"{m} {per[m]:.1f} ns a copy (t({lo}) "
              f"{recs[-2 + i]['ms']:.3f} ms, bound "
              f"{recs[-2 + i]['bound_ms']:.4f} ms by bytes)"
              for i, m in enumerate(dm.MODES))
          + f"; sync - db {per['sync'] - per['db']:.1f} ns a copy hidden by "
          f"the prefetch; launches {launches}; phase 15 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return recs


def dragon_frame(tag, scene, cam, cfg, expect):
    """Phase 13's frame under ``cfg``: a 1 spp warm-up, then the frame
    timed, with the launch counts set to 0 just before it and read just
    after; the kernels that ran must be ``expect``. Returns (image,
    launches)."""
    render_regen(scene, cam, cfg, ns=1)  # warm-up
    reset_launches()
    (fb, iters), secs, wall = render_timed(
        lambda: render_regen(scene, cam, cfg, return_iters=True))
    launches = read_launches()
    if set(launches) != set(expect):
        raise AssertionError(f"{tag}: launched {launches}, expected "
                             f"{sorted(expect)}")
    img = fb.cpu().numpy().reshape(cfg.ny, cfg.nx, 3)
    r, s = gate_crop(tag, img, DRAGON_GOLDEN)
    paths = cfg.num_pixels * cfg.ns
    phase("dragon", f"{tag} {cfg.nx}x{cfg.ny} {cfg.ns} spp depth "
          f"{cfg.max_depth}: {secs:.3f} s (CUDA events; host wall "
          f"{wall:.3f} s), {paths / secs / 1e6:.3f} Mpaths/s, {iters} "
          f"regen iterations, kernel launches {launches}, mean "
          f"{img.mean():.4f}; crop vs TPU golden rmse {r:.3e} "
          f"ssim {s:.6f}")
    return img, launches


def mx_frame_checks(scene, cam, cfg, base, mx_img):
    """mx_leaf against the default frame beyond phase 13's first frame:
    the same comparison on two more 4-sample windows of the frame (sample
    indices from 4 and from 8), each under MX_FRAME_RMSE; and the mx_leaf
    frame at mx_passes=6, which must come closer to ``base``, the default
    frame, than ``mx_img``, the one at 3 passes."""
    frame = lambda c, s0: render_regen(scene, cam, c, s0=s0).cpu().numpy(
        ).reshape(cfg.ny, cfg.nx, 3)
    mcfg = cfg.replace(mx_leaf=True)
    three = golden.rmse(mx_img, base)
    windows = {s0: golden.rmse(frame(mcfg, s0), frame(cfg, s0))
               for s0 in (4, 8)}
    six = frame(mcfg.replace(mx_passes=6), 0)
    r6 = golden.rmse(six, base)
    text = (", ".join(f"samples {s0}-{s0 + cfg.ns - 1}: rmse {r:.3e}"
                      for s0, r in windows.items())
            + f"; mx_passes=6: rmse {r6:.3e} ssim "
            f"{golden.ssim(six, base):.6f} (3 passes: {three:.3e})")
    if max(windows.values()) >= MX_FRAME_RMSE or not r6 < three:
        raise AssertionError(f"dragon mx_leaf=True vs the default frame: "
                             f"{text} (bound {MX_FRAME_RMSE}, and 6 passes "
                             "closer than 3)")
    phase("dragon", f"mx_leaf=True vs the default frame on {text}")


def dragon_path(dev):
    """Phases 10, 10c, 10d and 13. Returns the JSON records of K5, K6, the
    heap tier's variants (K10, K10b, K11, K5/K6 fast_math), the packet
    walk (K12a, K12b) and the walk probes (K13, K16)."""
    cfg = RenderConfig(**DRAGON)
    t0 = time.perf_counter()
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, device=dev, **DRAGON_MESH)
    if wf.mesh_tier(scene, cfg) != "heap":
        raise AssertionError("the dragon-class knot left the heap tier")
    phase("scene", f"dragon-class knot built in "
          f"{time.perf_counter() - t0:.1f} s: {scene.mesh.num_tris} heap "
          f"slots, first_leaf {scene.mesh.first_leaf}, "
          f"{scene.mesh.prims_per_leaf} a leaf, tier heap")
    tabs = cb.heap_tables(scene.mesh)
    kern = BvhKernels("heap", tabs)
    (err, ms, plain_ms, bnd), (err_a, ms_a, plain_a, bnd_a), rays = \
        bvh_kernel_phase("heap dragon", scene, cam, cfg, kern)
    variants = heap_variants_phase(scene.mesh, tabs, rays, cfg.epsilon)
    mr_recs = mr_phase(tabs, rays, cfg.epsilon, (bnd, bnd_a))
    probe_recs = walk_probe_phase(tabs, rays, cfg.epsilon)

    base, launches = dragon_frame("dragon", scene, cam, cfg,
                                  {"cuda_bvh.nearest", "cuda_bvh.any_hit"})
    knob_launches, knob_imgs = {}, {}
    for knobs, bound_text in DRAGON_KNOBS:
        kcfg = cfg.replace(**knobs)
        name = ", ".join(f"{k}={v}" for k, v in knobs.items())
        route = {"heap-mx": {"cuda_bvh_mx.nearest", "cuda_bvh_mx.any_hit"},
                 "heap-rg": {"cuda_bvh_rg.nearest", "cuda_bvh.any_hit"}}
        expect = route.get(wf.mesh_tier(scene, kcfg), (
            {"cuda_bvh.nearest_fast_math", "cuda_bvh.any_hit_fast_math"}
            if kcfg.fast_math else {"cuda_bvh.nearest", "cuda_bvh.any_hit"}))
        img, knob_launches[name] = dragon_frame(f"dragon {name}", scene,
                                                cam, kcfg, expect)
        knob_imgs[name] = img
        r, s = golden.rmse(img, base), golden.ssim(img, base)
        ok = {"packet_packs=2, packet_split=True":
              bool(np.array_equal(img, base)),
              "regroup=True": r < 1e-4,
              "fast_math=True": s >= 0.999,
              "mx_leaf=True": s >= 0.999 and r < MX_FRAME_RMSE}[name]
        if not ok:
            raise AssertionError(f"dragon {name} vs default frame: rmse "
                                 f"{r:.3e} ssim {s:.6f} (bound: "
                                 f"{bound_text})")
        phase("dragon", f"{name} vs the default frame: rmse {r:.3e} ssim "
              f"{s:.6f} max |diff| {np.abs(img - base).max():.3e} (bound: "
              f"{bound_text})")
    mx_frame_checks(scene, cam, cfg, base, knob_imgs["mx_leaf=True"])
    mx_l = knob_launches["mx_leaf=True"]
    rg_l = knob_launches["regroup=True"]
    fm_l = knob_launches["fast_math=True"]
    rec = lambda name, src, rep, n, key: record(name, src, rep, n,
                                                *variants[key])
    return [record("heap_trace", "bvh.cu", OPS + "pallas_bvh.py:937",
                   launches["cuda_bvh.nearest"], err, ms, plain_ms, bnd),
            record("heap_occluded", "bvh.cu", OPS + "pallas_bvh.py:1393",
                   launches["cuda_bvh.any_hit"], err_a, ms_a, plain_a,
                   bnd_a),
            rec("heap_trace_fast_math", "bvh.cu", OPS + "pallas_bvh.py:937",
                fm_l["cuda_bvh.nearest_fast_math"], "heap_trace_fast_math"),
            rec("heap_occluded_fast_math", "bvh.cu",
                OPS + "pallas_bvh.py:1393",
                fm_l["cuda_bvh.any_hit_fast_math"],
                "heap_occluded_fast_math"),
            rec("mx_trace", "bvh_mx.cu", OPS + "pallas_bvh_mx.py:190",
                mx_l["cuda_bvh_mx.nearest"], "mx_trace"),
            rec("mx_occluded", "bvh_mx.cu", OPS + "pallas_bvh_mx.py:302",
                mx_l["cuda_bvh_mx.any_hit"], "mx_occluded"),
            rec("rg_trace", "bvh_rg.cu", OPS + "pallas_bvh_rg.py:230",
                rg_l["cuda_bvh_rg.nearest"], "rg_trace"), *mr_recs,
            *probe_recs]


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
    kernels = [*spheres_path(dev), *staircase_path(dev),
               *staircase_hires_path(dev), *dragon_path(dev),
               *leaf_probe_phase(dev)]
    phase("done", f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
