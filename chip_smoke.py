"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two ported paths on the card through
``tpu_pathtracer_torch.engine.regen`` — the random-spheres headline
(BASELINE config 3: 1200x800, 100 spp, max depth 50) and the procedural
staircase (the staircase-toy row of bench.py: 1200x800, 100 spp, max
depth 64; triangle mesh, textures, NEE shadow rays) — after building the
CUDA kernels from ``tpu_pathtracer_torch/csrc`` and holding each against
its plain PyTorch version at the shapes its path gives it. Phases, one
line each; any failure raises and exits non-zero:

  1. device: the nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc builds spheres.cu and tris.cu side by side, g++ the
     native BVH builder (seconds, ptxas lines, which BVH builder ran);
  3. spheres, kernel vs plain on the 960,000 primary rays of sample 0 and
     on the second-bounce rays of the plain path, in all three modes;
     times (CUDA events, median of 7 warm runs);
  4. spheres end to end, small: 96x64, 4 spp, max depth 8, rendered
     through the kernel and through the plain version: rmse < 5e-3,
     SSIM >= 0.99;
  5. spheres end to end, full size, through the kernel: seconds, Mpaths/s,
     and the 128x128 center crop against the committed TPU-rendered
     golden assets/bench_spheres_100spp.ref: rmse < 5e-3, SSIM >= 0.99;
  6. triangles, kernel vs plain at the staircase's shapes: the 960,000
     primary rays, the second-bounce rays and the first bounce's NEE
     shadow rays (light-distance t_max, -1 on lanes without one), in all
     three modes: idx equal except exact ties, t within 2 ulp, u, v and
     features bit-equal, occ equal; times as in phase 3;
  7. staircase end to end, small: 96x64, 4 spp, max depth 8, kernel vs
     plain: rmse < 5e-3, SSIM >= 0.99;
  8. staircase end to end, full size, through the kernel: seconds,
     Mpaths/s, regen iterations, launches of the nearest-hit and any-hit
     modes (both must be > 0), and the 128x128 center crop against the
     committed TPU-rendered golden assets/bench_staircase_toy_100spp.ref:
     rmse < 5e-3, SSIM >= 0.99.

Each full-size run resets the launch counts just before it and reads
them just after. The line before the last is the kernels' JSON record;
the last line is ``{"ok": true, "device": {...}}``. Needs a CUDA device:
without one it exits non-zero and prints no result. Imports nothing of
JAX.
"""

import concurrent.futures
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
from tpu_pathtracer_torch.engine.regen import (render_image_regen,
                                               render_regen)
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops import cuda_tris as ct
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX
from tpu_pathtracer_torch.utils import golden

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(nx=1200, ny=800, ns=100, max_depth=50)
STAIRCASE = dict(nx=1200, ny=800, ns=100, max_depth=64)
SMALL = dict(nx=96, ny=64, ns=4, max_depth=8)
GOLDEN = os.path.join(ROOT, "assets", "bench_spheres_100spp.ref")
STAIR_GOLDEN = os.path.join(ROOT, "assets", "bench_staircase_toy_100spp.ref")
RMSE_TOL, SSIM_MIN = 5e-3, 0.99  # the oracle-gate bounds of bench.py
T_RTOL = 2.0 ** -22              # 2 ulp: -fmad=false makes t bit-equal


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
    phase("kernel", f"{tag}: {origin.x.shape[0]} rays x "
          f"{view.sph_r.shape[0]} spheres: idx equal on "
          f"{int(same.sum())}/{same.numel()} lanes ({mism.numel()} ties), "
          f"hits {int(hit.sum())}, max |err| t+features {err:.3e}, "
          f"occ equal ({int(o_k.sum())} occluded); features "
          f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, t/idx {ms_soa:.3f} ms "
          f"vs plain {plain_soa:.3f} ms, any-hit {ms_any:.3f} ms vs plain "
          f"{plain_any:.3f} ms")
    return err, ms, plain_ms


def compare_tri_nearest(tag, origin, direction, view, eps, t_max):
    """The triangle kernel's features and t/idx modes against the plain
    version on one ray set. Returns (max abs error over t, u, v and
    features, features ms, plain ms, t/idx ms, plain ms)."""
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
    phase("kernel", f"{tag}: {origin.x.shape[0]} rays x "
          f"{view.tri_v0.x.shape[0]} triangles: idx equal on "
          f"{int(same.sum())}/{same.numel()} lanes ({mism.numel()} ties), "
          f"hits {int(hit.sum())}, max |err| t+features {err:.3e}, u/v "
          f"bit-equal; features {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
          f"t/idx {ms_soa:.3f} ms vs plain {plain_soa:.3f} ms")
    return err, ms, plain_ms, ms_soa, plain_soa


def compare_tri_anyhit(tag, origin, direction, view, eps, t_max):
    """The triangle kernel's any-hit mode against the plain version.
    Returns (kernel ms, plain ms)."""
    args = (origin, direction, view.tri_v0, view.tri_e1, view.tri_e2,
            view.tri_n, eps, t_max)
    o_k = ct.tris_anyhit_soa(*args)
    o_p = ct._tris_anyhit_ref(*args)
    if not torch.equal(o_k, o_p):
        raise AssertionError(f"{tag}: any-hit differs on "
                             f"{(o_k != o_p).sum().item()} lanes")
    if bool(o_k[t_max <= eps].any()):
        raise AssertionError(f"{tag}: a lane without a shadow ray is "
                             "occluded")
    ms = cuda_ms(lambda: ct.tris_anyhit_soa(*args))
    plain_ms = cuda_ms(lambda: ct._tris_anyhit_ref(*args))
    phase("kernel", f"{tag}: {origin.x.shape[0]} rays "
          f"({int((t_max > eps).sum())} shadow rays) x "
          f"{view.tri_v0.x.shape[0]} triangles: occ equal "
          f"({int(o_k.sum())} occluded); any-hit {ms:.3f} ms vs plain "
          f"{plain_ms:.3f} ms")
    return ms, plain_ms


def build_all():
    """Build both kernels and the BVH builder side by side."""
    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        return out, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = {name: ex.submit(timed, _build.build, name)
                for name in ("spheres", "tris")}
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
    err1, ms, plain_ms = compare_modes("spheres primary", o1, d1, view,
                                       cfg.epsilon, FLT_MAX)
    with mock.patch.object(cs, "spheres_hit_feat", cs._spheres_hit_feat_ref):
        st, _ = wf.bounce_step(scene, view, cfg,
                               wf.initial_state(o1, d1, torch.ones_like(
                                   pix, dtype=torch.bool)), pix, 0, 0)
    live = st.alive
    o2 = V3(*(c[live].contiguous() for c in st.origin))
    d2 = V3(*(c[live].contiguous() for c in st.direction))
    err2, _, _ = compare_modes("spheres bounce-2", o2, d2, view,
                               cfg.epsilon, FLT_MAX)

    scfg = RenderConfig(**SMALL)
    sscene, scam = random_spheres_scene(scfg.nx, scfg.ny, device=dev)
    img_k = render_image_regen(sscene, scam, scfg)
    with mock.patch.object(cs, "spheres_hit_feat", cs._spheres_hit_feat_ref):
        img_p = render_image_regen(sscene, scam, scfg)
    r4, s4 = golden.rmse(img_k, img_p), golden.ssim(img_k, img_p)
    if not (np.isfinite(img_k).all() and r4 < RMSE_TOL and s4 >= SSIM_MIN):
        raise AssertionError(f"spheres small render: rmse {r4:.3e} "
                             f"ssim {s4:.5f}")
    phase("small", f"spheres {scfg.nx}x{scfg.ny} {scfg.ns} spp depth "
          f"{scfg.max_depth}: kernel vs plain rmse {r4:.3e} ssim {s4:.6f} "
          f"max |diff| {np.abs(img_k - img_p).max():.3e}")

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
    return {"name": "spheres_hit_feat", "route": "cuda",
            "source": "tpu_pathtracer_torch/csrc/spheres.cu",
            "replaces": "tpu_pathtracer/ops/pallas_spheres.py:73",
            "launches": launches, "max_abs_err": max(err1, err2),
            "ms": ms, "plain_ms": plain_ms}


def staircase_path(dev):
    """Phases 6-8. Returns the kernel's JSON records (features mode, the
    nearest hit of the path, and any-hit, its shadow rays)."""
    cfg = RenderConfig(**STAIRCASE)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny, device=dev)
    view = wf.make_view(scene, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    err1, ms, plain_ms, _, _ = compare_tri_nearest(
        "tris primary", o1, d1, view, cfg.epsilon, FLT_MAX)
    # the first bounce through the plain versions; its shadow rays are
    # caught on their way into the any-hit test
    shadow = {}

    def catch_shadow(scene_, view_, config_, origin, direction, t_max):
        shadow.update(origin=origin, direction=direction, t_max=t_max)
        return ct._tris_anyhit_ref(origin, direction, view_.tri_v0,
                                   view_.tri_e1, view_.tri_e2, view_.tri_n,
                                   config_.epsilon, t_max)

    with mock.patch.object(ct, "tris_hit_feat", ct._tris_hit_feat_ref), \
            mock.patch.object(wf, "occluded", catch_shadow):
        st, _ = wf.bounce_step(scene, view, cfg,
                               wf.initial_state(o1, d1, torch.ones_like(
                                   pix, dtype=torch.bool)), pix, 0, 0)
    live = st.alive
    o2 = V3(*(c[live].contiguous() for c in st.origin))
    d2 = V3(*(c[live].contiguous() for c in st.direction))
    err2, _, _, _, _ = compare_tri_nearest("tris bounce-2", o2, d2, view,
                                           cfg.epsilon, FLT_MAX)
    ms_any, plain_any = compare_tri_anyhit(
        "tris NEE shadows", shadow["origin"], shadow["direction"], view,
        cfg.epsilon, shadow["t_max"].contiguous())

    scfg = RenderConfig(**SMALL)
    sscene, scam = procedural_staircase_scene(scfg.nx, scfg.ny, device=dev)
    img_k = render_image_regen(sscene, scam, scfg)
    with mock.patch.object(ct, "tris_hit_feat", ct._tris_hit_feat_ref), \
            mock.patch.object(ct, "tris_anyhit_soa", ct._tris_anyhit_ref):
        img_p = render_image_regen(sscene, scam, scfg)
    r7, s7 = golden.rmse(img_k, img_p), golden.ssim(img_k, img_p)
    if not (np.isfinite(img_k).all() and r7 < RMSE_TOL and s7 >= SSIM_MIN):
        raise AssertionError(f"staircase small render: rmse {r7:.3e} "
                             f"ssim {s7:.5f}")
    phase("small", f"staircase {scfg.nx}x{scfg.ny} {scfg.ns} spp depth "
          f"{scfg.max_depth}: kernel vs plain rmse {r7:.3e} ssim "
          f"{s7:.6f} max |diff| {np.abs(img_k - img_p).max():.3e}")

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
    rec = {"route": "cuda", "source": "tpu_pathtracer_torch/csrc/tris.cu",
           "replaces": "tpu_pathtracer/ops/pallas_tris.py:77"}
    return [dict(name="tris_hit_feat", launches=launches["features"],
                 max_abs_err=max(err1, err2), ms=ms, plain_ms=plain_ms,
                 **rec),
            dict(name="tris_anyhit_soa", launches=launches["any_hit"],
                 max_abs_err=0.0, ms=ms_any, plain_ms=plain_any, **rec)]


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); nothing runs on the CPU in its place")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    build_all()
    kernels = [spheres_path(dev), *staircase_path(dev)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
