"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the random-spheres headline scene
(BASELINE config 3: 1200x800, 100 spp, max depth 50) through
``tpu_pathtracer_torch.engine.regen.render_image_regen`` — on the card,
after building the CUDA sphere kernel from ``tpu_pathtracer_torch/csrc``
and holding it against its plain PyTorch version at the headline's
shapes. Phases, one line each; any failure raises and exits non-zero:

  1. device: the nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc builds the kernel (seconds, ptxas lines);
  3. kernel vs plain on the 960,000 primary rays of sample 0 and on the
     second-bounce rays of the plain path, in all three modes; times
     (CUDA events, median of 7 warm runs);
  4. end to end, small: 96x64, 4 spp, max depth 8, rendered through the
     kernel and through the plain version: rmse < 5e-3, SSIM >= 0.99;
  5. end to end, full size, through the kernel: wall seconds, Mpaths/s,
     and the 128x128 center crop against the committed TPU-rendered
     golden assets/bench_spheres_100spp.ref: rmse < 5e-3, SSIM >= 0.99.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs a CUDA device: without one it
exits non-zero and prints no result. Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine import wavefront as wf
from tpu_pathtracer_torch.engine.regen import render_image_regen
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX
from tpu_pathtracer_torch.utils import golden

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(nx=1200, ny=800, ns=100, max_depth=50)
SMALL = dict(nx=96, ny=64, ns=4, max_depth=8)
GOLDEN = os.path.join(ROOT, "assets", "bench_spheres_100spp.ref")
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


def compare_modes(tag, origin, direction, view, eps, flt_max):
    """All three modes, kernel against plain, on one ray set. Returns
    (max abs error over t and features, kernel ms, plain ms) of the
    features mode."""
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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); nothing runs on the CPU in its place")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    # ---- 2. build
    t0 = time.perf_counter()
    lib = _build.build("spheres")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", f"spheres.cu built in {build_s:.1f} s: "
          + " | ".join(ptxas))

    # ---- 3. kernel vs plain at the headline's shapes
    cfg = RenderConfig(**HEADLINE)
    scene, cam = random_spheres_scene(cfg.nx, cfg.ny, device=dev)
    view = wf.make_view(scene, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    err1, ms, plain_ms = compare_modes("primary", o1, d1, view,
                                       cfg.epsilon, FLT_MAX)
    with mock.patch.object(cs, "spheres_hit_feat", cs._spheres_hit_feat_ref):
        st, _ = wf.bounce_step(scene, view, cfg,
                               wf.initial_state(o1, d1, torch.ones_like(
                                   pix, dtype=torch.bool)), pix, 0, 0)
    live = st.alive
    o2 = V3(*(c[live].contiguous() for c in st.origin))
    d2 = V3(*(c[live].contiguous() for c in st.direction))
    err2, _, _ = compare_modes("bounce-2", o2, d2, view, cfg.epsilon,
                               FLT_MAX)

    # ---- 4. end to end, small: kernel vs plain sphere function
    scfg = RenderConfig(**SMALL)
    sscene, scam = random_spheres_scene(scfg.nx, scfg.ny, device=dev)
    img_k = render_image_regen(sscene, scam, scfg)
    with mock.patch.object(cs, "spheres_hit_feat", cs._spheres_hit_feat_ref):
        img_p = render_image_regen(sscene, scam, scfg)
    r4, s4 = golden.rmse(img_k, img_p), golden.ssim(img_k, img_p)
    if not (np.isfinite(img_k).all() and r4 < RMSE_TOL and s4 >= SSIM_MIN):
        raise AssertionError(f"small render: rmse {r4:.3e} ssim {s4:.5f}")
    phase("small", f"{scfg.nx}x{scfg.ny} {scfg.ns} spp depth "
          f"{scfg.max_depth}: kernel vs plain rmse {r4:.3e} ssim {s4:.6f} "
          f"max |diff| {np.abs(img_k - img_p).max():.3e}")

    # ---- 5. end to end, full size, through the kernel
    render_image_regen(scene, cam, cfg, ns=1)  # warm-up
    torch.cuda.synchronize()
    cs.LAUNCHES = 0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    w0 = time.perf_counter()
    a.record()
    img = render_image_regen(scene, cam, cfg)
    b.record()
    b.synchronize()
    wall = time.perf_counter() - w0
    launches = cs.LAUNCHES
    secs = a.elapsed_time(b) / 1e3
    if launches <= 0:
        raise AssertionError("the headline render launched no sphere kernel")
    if img.shape != (cfg.ny, cfg.nx, 3) or not np.isfinite(img).all():
        raise AssertionError(f"bad image: shape {img.shape}")
    cy, cx = cfg.ny // 2, cfg.nx // 2
    crop = np.ascontiguousarray(img[cy - 64:cy + 64, cx - 64:cx + 64])
    ref = golden.load_reference(GOLDEN)
    r5, s5 = golden.rmse(crop, ref), golden.ssim(crop, ref)
    if not (r5 < RMSE_TOL and s5 >= SSIM_MIN):
        raise AssertionError(f"headline crop vs golden: rmse {r5:.3e} "
                             f"ssim {s5:.5f}")
    paths = cfg.num_pixels * cfg.ns
    phase("headline", f"{cfg.nx}x{cfg.ny} {cfg.ns} spp depth "
          f"{cfg.max_depth}: {secs:.3f} s (CUDA events; host wall "
          f"{wall:.3f} s), {paths / secs / 1e6:.3f} Mpaths/s, "
          f"{launches} kernel launches = regen iterations, mean "
          f"{img.mean():.4f}; crop vs TPU golden rmse {r5:.3e} "
          f"ssim {s5:.6f}")

    print(json.dumps({"kernels": [{
        "name": "spheres_hit_feat",
        "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/spheres.cu",
        "replaces": "tpu_pathtracer/ops/pallas_spheres.py:73",
        "launches": launches,
        "max_abs_err": max(err1, err2),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
