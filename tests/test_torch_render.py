"""End-to-end parity of the port: its scenes against the JAX package's,
its renders against the independent NumPy oracle and against the JAX
engines on the feature-kernel path (``force_feat_kernels=True``, the
path the TPU runs), and its own engine invariants."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.engine.regen import render_image_regen as j_regen
from tpu_pathtracer.engine.render import render_image as j_render
from tpu_pathtracer.models import scene as jsc
from tpu_pathtracer.models import spheres as jspheres
from tpu_pathtracer.oracle import render_oracle
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.convert import camera_from_numpy, scene_from_numpy
from tpu_pathtracer_torch.engine import wavefront
from tpu_pathtracer_torch.engine.regen import (render_image_regen,
                                               render_sample_range)
from tpu_pathtracer_torch.engine.render import Renderer, render_image
from tpu_pathtracer_torch.models import mesh as tmesh
from tpu_pathtracer_torch.models import spheres as tspheres
from tpu_pathtracer_torch.models.scene import Scene
from tpu_pathtracer_torch.utils import golden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = {**os.environ, "PYTHONPATH": os.pathsep.join(
    filter(None, [ROOT, os.environ.get("PYTHONPATH")]))}
SCENES = {"three-sphere": ("three_sphere_scene", 48, 32),
          "spheres": ("random_spheres_scene", 60, 40)}
# image bounds of the JAX package's own oracle test
# (tests/test_render_golden.py:17-23): the port and the reference agree
# path for path up to transcendental ulps, which flip a handful of paths
RMSE_TOL, SSIM_MIN, MEAN_TOL = 5e-3, 0.98, 1e-3


def jax_fields(obj):
    """A JAX scene or camera as the numpy dict ``convert`` takes."""
    if dataclasses.is_dataclass(obj):
        return {f.name: jax_fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(jax_fields(x) for x in obj)
    if obj is None or isinstance(obj, (bool, int, float)):
        return obj
    return np.asarray(obj)


def jax_camera_fields(cam):
    names = ("origin", "lower_left_corner", "horizontal", "vertical", "u",
             "v", "w", "lens_radius")
    return {k: np.asarray(getattr(cam, k)) for k in names}


def converted(js, jc):
    return (scene_from_numpy(jax_fields(js), "cpu"),
            camera_from_numpy(jax_camera_fields(jc), "cpu"))


def assert_close_images(img, ref, ssim_min=SSIM_MIN):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert golden.rmse(img, ref) < RMSE_TOL
    assert golden.ssim(img, ref) > ssim_min
    assert abs(float((img - ref).mean())) < MEAN_TOL


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_arrays_equal_jax(name):
    fn, nx, ny = SCENES[name]
    js, jc = getattr(jspheres, fn)(nx, ny)
    ts, tc = getattr(tspheres, fn)(nx, ny, device="cpu")
    if name == "spheres":
        assert ts.sphere_center.shape[0] == 486
    want = jax_fields(js)
    for f in dataclasses.fields(Scene):
        got, exp = getattr(ts, f.name), want[f.name]
        if f.name == "materials":
            for k, v in exp.items():
                np.testing.assert_array_equal(getattr(got, k).numpy(), v)
        elif isinstance(exp, np.ndarray):
            np.testing.assert_array_equal(got.numpy(), exp, err_msg=f.name)
        else:
            assert got == exp, f.name
    # the converted JAX scene is the port's own scene, array for array
    cs, _ = converted(js, jc)
    for f in dataclasses.fields(Scene):
        a, b = getattr(cs, f.name), getattr(ts, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        elif f.name == "materials":
            for k in a.__dataclass_fields__:
                assert torch.equal(getattr(a, k), getattr(b, k)), k
        else:
            assert a == b, f.name
    for k, v in jax_camera_fields(jc).items():
        np.testing.assert_allclose(getattr(tc, k).numpy(), v, atol=1e-5)


def test_three_sphere_matches_oracle():
    cfg = RenderConfig(nx=48, ny=32, ns=8, max_depth=8)
    jcfg = JConfig(nx=48, ny=32, ns=8, max_depth=8)
    ts, tc = tspheres.three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    js, jc = jspheres.three_sphere_scene(cfg.nx, cfg.ny)
    assert_close_images(render_image(ts, tc, cfg),
                        render_oracle(js, jc, jcfg))


@pytest.mark.parametrize("engine", ["regen", "plain"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_matches_jax_feature_kernel_path(name, engine):
    fn, nx, ny = SCENES[name]
    js, jc = getattr(jspheres, fn)(nx, ny)
    jcfg = JConfig(nx=nx, ny=ny, ns=2, max_depth=8, force_feat_kernels=True)
    cfg = RenderConfig(nx=nx, ny=ny, ns=2, max_depth=8)
    ts, tc = converted(js, jc)
    if engine == "regen":
        img, ref = render_image_regen(ts, tc, cfg), j_regen(js, jc, jcfg)
    else:
        img, ref = render_image(ts, tc, cfg), j_render(js, jc, jcfg)
    assert_close_images(img, np.asarray(ref))


def test_plane_and_light_match_jax():
    """The floor plane and the light sphere (NEE off: specular light hits
    add the light color) on the same scene in both packages."""
    mats = [dict(type=jsc.DIFFUSE, color=(0.6, 0.6, 0.6)),
            dict(type=jsc.METAL, color=(0.9, 0.9, 0.9), param=0.0),
            dict(type=jsc.GLASS, color=(1.0, 1.0, 1.0), param=1.5)]
    js = jsc.make_scene(
        jsc.make_materials(mats),
        sphere_center=np.array([[0, 1, -3], [1.5, 0.7, -3.5]], np.float32),
        sphere_radius=np.array([1.0, 0.7], np.float32),
        sphere_mat=np.array([1, 2], np.int32),
        plane_point=(0.0, 0.0, 0.0), plane_norm=(0.0, 1.0, 0.0),
        plane_mat=0, light_center=(0.0, 6.0, -3.0), light_radius=2.0,
        light_color=(4.0, 4.0, 4.0), use_nee=True, sky_mode=jsc.SKY_CONST)
    from tpu_pathtracer.camera import make_camera
    jc = make_camera((0.0, 1.5, 2.0), (0.0, 1.0, -3.0), (0.0, 1.0, 0.0),
                     60.0, 1.5)
    jcfg = JConfig(nx=36, ny=24, ns=4, max_depth=6, shadow=False,
                   force_feat_kernels=True)
    cfg = RenderConfig(nx=36, ny=24, ns=4, max_depth=6, shadow=False)
    ts, tc = converted(js, jc)
    assert_close_images(render_image(ts, tc, cfg),
                        np.asarray(j_render(js, jc, jcfg)))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_regen_matches_plain_engine(name):
    """Both engines trace the same paths (counter-based RNG); the
    per-pixel summation, the 1/ns scaling and the CPU's SIMD-tail ulps
    (see test_chunking_invariance) may round differently."""
    fn, nx, ny = SCENES[name]
    cfg = RenderConfig(nx=nx, ny=ny, ns=3, max_depth=8)
    ts, tc = getattr(tspheres, fn)(nx, ny, device="cpu")
    np.testing.assert_allclose(render_image_regen(ts, tc, cfg),
                               render_image(ts, tc, cfg), rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["regen", "plain"])
def test_chunking_invariance(engine):
    """The image does not depend on the lane-chunk (plain) or lane-pool
    (regen) size: each lane sums its pixel's samples in sample order.
    Not bit for bit on the CPU: PyTorch's CPU sin/cos/log/pow run
    vectorized code on full SIMD blocks and scalar code on the tail, so a
    lane's result can move by an ulp with its position in the tensor."""
    cfg = RenderConfig(nx=40, ny=24, ns=2, max_depth=4)
    ts, tc = tspheres.three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    fn = render_image_regen if engine == "regen" else render_image
    np.testing.assert_allclose(fn(ts, tc, cfg),
                               fn(ts, tc, cfg.replace(rays_per_chunk=250)),
                               rtol=1e-6, atol=1e-7)


def test_max_depth_zero_is_black():
    cfg = RenderConfig(nx=8, ny=8, ns=1, max_depth=0)
    ts, tc = tspheres.three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    np.testing.assert_array_equal(render_image(ts, tc, cfg), 0.0)


def test_sample_ranges_add_up():
    cfg = RenderConfig(nx=24, ny=16, ns=3, max_depth=6)
    ts, tc = tspheres.random_spheres_scene(cfg.nx, cfg.ny, device="cpu")
    whole = render_sample_range(ts, tc, cfg, 0, 3)
    parts = (render_sample_range(ts, tc, cfg, 0, 2)
             + render_sample_range(ts, tc, cfg, 2, 1))
    np.testing.assert_allclose(parts, whole, rtol=1e-6, atol=0)
    np.testing.assert_allclose(whole / 3.0, render_image_regen(ts, tc, cfg),
                               rtol=1e-6, atol=1e-7)


def test_stats_match_jax_plain_engine():
    """primary is exact; ulp-level divergence moves a few paths, so the
    path-length counters agree within 1%."""
    nx, ny = 60, 40
    js, jc = jspheres.random_spheres_scene(nx, ny)
    jcfg = JConfig(nx=nx, ny=ny, ns=2, max_depth=8, stats=True,
                   force_feat_kernels=True)
    _, jst = j_render(js, jc, jcfg, report_stats=True)
    ts, tc = converted(js, jc)
    _, st = render_image(ts, tc, RenderConfig(nx=nx, ny=ny, ns=2,
                                              max_depth=8, stats=True),
                         report_stats=True)
    assert st.primary == int(jst.primary) == nx * ny * 2
    for k in ("secondary", "roulette_kill", "exceed_max_bounce"):
        a, b = getattr(st, k), int(getattr(jst, k))
        assert abs(a - b) <= 0.01 * b + 1, (k, a, b)
    assert st.roulette_kill > 0 and st.exceed_max_bounce > 0


def test_renderer_lifecycle_and_print_stats(capsys):
    cfg = RenderConfig(nx=16, ny=12, ns=2, max_depth=4, stats=True)
    ts, tc = tspheres.three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    r = Renderer(ts, tc, cfg)
    fb = r.run()
    assert fb.shape == (12, 16, 3) and r.framebuffer is fb
    assert r.stats.primary == 16 * 12 * 2
    r.print_stats()
    out = capsys.readouterr().out
    assert "num rays:" in out and f"{'primary':20s}: 384" in out
    r.cleanup()
    assert r.scene is None and r.framebuffer is None


def test_unported_features_raise():
    """A mesh the JAX package sends to its packet-BVH kernels (use_bvh,
    more than packet_threshold triangles) renders through the heap walk
    (slice 3) in both engines, the same image as the brute-force kernel
    and the oracle; the heap kernel variants once unported (slice 5:
    fast_math, mx_leaf, regroup) now render through their routes in both
    engines, within their bounds against the heap render: fast_math bit
    for bit on the CPU (the plain versions keep the exact division),
    regroup rmse < 1e-4 (tests/test_packet_rg.py:150), mx_leaf rmse < 1e-3
    and SSIM >= 0.999."""
    ts, tc = tmesh.procedural_staircase_scene(8, 8, device="cpu")
    cfg = RenderConfig(nx=8, ny=8, ns=1, max_depth=2, packet_threshold=600)
    assert ts.mesh.num_tris == 640
    heap = render_image(ts, tc, cfg)
    np.testing.assert_array_equal(render_image_regen(ts, tc, cfg), heap)
    np.testing.assert_array_equal(
        render_image(ts, tc, cfg.replace(packet_threshold=640)), heap)
    assert render_image(ts, tc, cfg.replace(use_bvh=False)).mean() > 0
    for knob, route in (("fast_math", "heap"), ("mx_leaf", "heap-mx"),
                        ("regroup", "heap-rg")):
        kcfg = cfg.replace(**{knob: True})
        assert wavefront.mesh_tier(ts, kcfg) == route
        img = render_image(ts, tc, kcfg)
        np.testing.assert_array_equal(render_image_regen(ts, tc, kcfg), img)
        if knob == "fast_math":
            np.testing.assert_array_equal(img, heap)
        elif knob == "regroup":
            assert golden.rmse(img, heap) < 1e-4
        else:
            assert golden.rmse(img, heap) < 1e-3
            assert golden.ssim(img, heap) >= 0.999


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "tpu_pathtracer_torch", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env=_ENV)


def test_cli_renders_png_and_stats(tmp_path):
    out = tmp_path / "o.png"
    p = _cli("--scene", "three-sphere", "--nx", "16", "--ny", "8", "--ns",
             "1", "--max-depth", "3", "-o", str(out), "--device", "cpu",
             cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    assert out.stat().st_size > 0 and "took" in p.stderr
    p = _cli("--scene", "spheres", "--nx", "12", "--ny", "8", "--ns", "1",
             "--max-depth", "3", "--engine", "plain", "--stats",
             "--store-ref", "--device", "cpu", cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    assert "primary" in p.stderr and (tmp_path / "f12-8.ref").exists()


@pytest.mark.parametrize(
    "scene,slice_", [("staircase-hires", "slice 3"), ("knot", "slice 3"),
                     ("zoo-glass", "slice 3")],
    ids=["staircase-hires-slice 3", "knot-slice 3", "zoo-glass-slice 3"])
def test_cli_names_the_slice_of_unported_scenes(tmp_path, scene, slice_):
    """The scenes slice 3 brought are the CLI's; like every scene they
    render on the card, and without one the CLI exits non-zero naming
    ``--device cpu`` instead of falling back to the CPU."""
    p = _cli("--scene", scene, "--nx", "8", "--ny", "8", cwd=tmp_path)
    assert p.returncode != 0 and "--device cpu" in p.stderr
    assert "unknown scene" not in p.stderr
