"""End-to-end parity of the port's staircase path (triangle mesh, image
textures, NEE shadow rays): against the JAX engines on the feature-kernel
path (``force_feat_kernels=True``, the path a TPU runs for a small mesh),
against the independent NumPy oracle and the committed golden, and its
own invariants."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_pathtracer.camera import make_camera as j_make_camera
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.engine.regen import render_image_regen as j_regen
from tpu_pathtracer.engine.render import render_image as j_render
from tpu_pathtracer.models import mesh as jmesh
from tpu_pathtracer.models import scene as jsc
from tpu_pathtracer.ops import bvh as jbvh
from tpu_pathtracer.oracle import render_oracle
from test_torch_render import converted
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.regen import render_image_regen
from tpu_pathtracer_torch.engine.render import render_image
from tpu_pathtracer_torch.models import mesh as tmesh
from tpu_pathtracer_torch.ops import cuda_tris as ct
from tpu_pathtracer_torch.utils import golden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = {**os.environ, "PYTHONPATH": os.pathsep.join(
    filter(None, [ROOT, os.environ.get("PYTHONPATH")]))}
# the JAX package's own bounds for the staircase against the oracle
# (tests/test_render_golden.py:26-33); the port and the JAX package trace
# the same paths up to transcendental ulps (sin/cos in the NEE sampler),
# which move a few paths, so the same bounds hold port against JAX
RMSE_TOL, SSIM_MIN, MEAN_TOL = 0.01, 0.97, 1e-3


def assert_close_images(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert golden.rmse(img, ref) < RMSE_TOL
    assert golden.ssim(img, ref) > SSIM_MIN
    assert abs(float((img - ref).mean())) < MEAN_TOL


def _configs(**kw):
    return RenderConfig(**kw), JConfig(force_feat_kernels=True, **kw)


@pytest.mark.parametrize("engine", ["regen", "plain"])
def test_matches_jax_feature_kernel_path(engine):
    cfg, jcfg = _configs(nx=32, ny=24, ns=2, max_depth=8)
    js, jc = jmesh.procedural_staircase_scene(cfg.nx, cfg.ny)
    ts, tc = converted(js, jc)
    if engine == "regen":
        img, ref = render_image_regen(ts, tc, cfg), j_regen(js, jc, jcfg)
    else:
        img, ref = render_image(ts, tc, cfg), j_render(js, jc, jcfg)
    assert_close_images(img, np.asarray(ref))
    assert img.mean() > 0.05


@pytest.mark.parametrize("knob", ["shadow", "textures"])
def test_variants_match_jax(knob):
    """NEE off (specular light hits add the light color) and textures
    off (the material color as albedo)."""
    cfg, jcfg = _configs(nx=32, ny=24, ns=2, max_depth=8, **{knob: False})
    js, jc = jmesh.procedural_staircase_scene(cfg.nx, cfg.ny)
    ts, tc = converted(js, jc)
    img = render_image(ts, tc, cfg)
    assert_close_images(img, np.asarray(j_render(js, jc, jcfg)))
    full = render_image(ts, tc, cfg.replace(**{knob: True}))
    assert np.abs(img - full).max() > 0.01  # the knob changes the image


def test_matches_oracle():
    """tests/test_render_golden.py:26-33, through the port."""
    cfg = RenderConfig(nx=40, ny=50, ns=4, max_depth=5)
    ts, tc = tmesh.procedural_staircase_scene(cfg.nx, cfg.ny,
                                              device="cpu")
    js, jc = jmesh.procedural_staircase_scene(cfg.nx, cfg.ny)
    ref = render_oracle(js, jc, JConfig(nx=40, ny=50, ns=4, max_depth=5))
    img = render_image(ts, tc, cfg)
    assert golden.rmse(img, ref) < 0.01
    assert golden.ssim(img, ref) > 0.97
    assert abs(float((img - ref).mean())) < 1e-3


def test_committed_golden():
    """The bound of tests/test_render_golden.py:136-147 (rmse < 1e-6) on
    the port's own scene: PyTorch contracts no FMA on the CPU, and the
    image agrees with the golden to float32 rounding."""
    cfg = RenderConfig(nx=24, ny=16, ns=2, max_depth=6, rays_per_chunk=128)
    ts, tc = tmesh.procedural_staircase_scene(cfg.nx, cfg.ny,
                                              device="cpu")
    img = render_image(ts, tc, cfg)
    ref = golden.load_reference(os.path.join(
        ROOT, "assets", "staircase_24x16_2spp.ref"), 24, 16)
    assert golden.rmse(img, ref) < 1e-6
    assert golden.ssim(img, ref) > 0.9999


@pytest.mark.parametrize("engine", ["regen", "plain"])
def test_bvh_on_equals_off(engine):
    """The brute-force kernel over the compacted triangles (use_bvh) and
    the all-triangles oracle over the padded heap (use_bvh=False) trace
    the same paths bit for bit."""
    cfg = RenderConfig(nx=32, ny=40, ns=2, max_depth=4)
    ts, tc = tmesh.procedural_staircase_scene(cfg.nx, cfg.ny,
                                              device="cpu")
    fn = render_image_regen if engine == "regen" else render_image
    np.testing.assert_array_equal(fn(ts, tc, cfg),
                                  fn(ts, tc, cfg.replace(use_bvh=False)))


def test_regen_matches_plain_engine():
    cfg = RenderConfig(nx=24, ny=20, ns=3, max_depth=10)
    ts, tc = tmesh.procedural_staircase_scene(cfg.nx, cfg.ny,
                                              device="cpu")
    np.testing.assert_allclose(render_image_regen(ts, tc, cfg),
                               render_image(ts, tc, cfg), rtol=0,
                               atol=1e-5)


def test_stats_match_jax_plain_engine():
    """primary and primary_hit_mesh are exact; ulp-level divergence in the
    NEE sampler moves a few paths, so the path-length and shadow counters
    agree within 1%. The bbox counters are 0 in both: every ray starts
    inside the mesh's bounds."""
    cfg, jcfg = _configs(nx=32, ny=24, ns=2, max_depth=8, stats=True)
    js, jc = jmesh.procedural_staircase_scene(cfg.nx, cfg.ny)
    _, jst = j_render(js, jc, jcfg, report_stats=True)
    ts, tc = converted(js, jc)
    _, st = render_image(ts, tc, cfg, report_stats=True)
    assert st.primary == st.primary_hit_mesh == int(jst.primary) == 1536
    for k in ("secondary", "secondary_mesh", "secondary_mesh_nohit",
              "shadows", "shadows_nohit", "roulette_kill"):
        a, b = getattr(st, k), int(getattr(jst, k))
        assert abs(a - b) <= 0.01 * b + 1, (k, a, b)
        assert a > 0, k
    for k in ("primary_bbox_nohit", "secondary_bbox_nohit",
              "shadows_bbox_nohit", "nodes_both", "nodes_single"):
        assert getattr(st, k) == int(getattr(jst, k)) == 0, k


def test_bbox_counters_count_rays_outside_the_mesh():
    """A camera outside the staircase's bounds, looking away from it: every
    primary ray misses the mesh's box, as in the JAX package."""
    cfg, jcfg = _configs(nx=8, ny=6, ns=1, max_depth=2, stats=True)
    js, _ = jmesh.procedural_staircase_scene(cfg.nx, cfg.ny)
    jc = j_make_camera((0.0, 200.0, 2000.0), (0.0, 200.0, 3000.0),
                       (0.0, 1.0, 0.0), 40.0, cfg.nx / cfg.ny)
    _, jst = j_render(js, jc, jcfg, report_stats=True)
    ts, tc = converted(js, jc)
    _, st = render_image(ts, tc, cfg, report_stats=True)
    assert st.primary_bbox_nohit == int(jst.primary_bbox_nohit) == 48


def test_sphere_scene_with_nee_matches_jax():
    """NEE in an analytic scene: the spheres are the occluders, through
    the sphere kernel's any-hit mode."""
    mats = [dict(type=jsc.DIFFUSE, color=(0.6, 0.6, 0.6)),
            dict(type=jsc.METAL, color=(0.9, 0.9, 0.9), param=0.2),
            dict(type=jsc.DIFFUSE, color=(0.2, 0.5, 0.8))]
    js = jsc.make_scene(
        jsc.make_materials(mats),
        sphere_center=np.array([[0, 1, -3], [1.5, 0.7, -3.5]], np.float32),
        sphere_radius=np.array([1.0, 0.7], np.float32),
        sphere_mat=np.array([1, 2], np.int32),
        plane_point=(0.0, 0.0, 0.0), plane_norm=(0.0, 1.0, 0.0),
        plane_mat=0, light_center=(0.0, 6.0, -3.0), light_radius=2.0,
        light_color=(4.0, 4.0, 4.0), use_nee=True, sky_mode=jsc.SKY_CONST)
    jc = j_make_camera((0.0, 1.5, 2.0), (0.0, 1.0, -3.0), (0.0, 1.0, 0.0),
                       60.0, 1.5)
    cfg, jcfg = _configs(nx=36, ny=24, ns=4, max_depth=6)
    ts, tc = converted(js, jc)
    img = render_image(ts, tc, cfg)
    assert_close_images(img, np.asarray(j_render(js, jc, jcfg)))


def _texture_dir(path):
    from PIL import Image

    rng = np.random.RandomState(3)
    for name in tmesh.STAIRCASE_TEXTURE_NAMES:
        px = rng.randint(0, 256, (12, 16, 3)).astype(np.uint8)
        Image.fromarray(px, "RGB").save(os.path.join(path, name))
    return str(path)


def test_loaded_bvh_scene_matches_jax(tmp_path):
    """A ``.bvh`` file's mesh has no compacted copy: the kernel runs over
    the heap's padded arrays, whose sentinel triangles must miss."""
    bvh = str(tmp_path / "stairs.bvh")
    jbvh.save_bvh_file(bvh, jmesh.procedural_staircase_scene(8, 8)[0].mesh)
    tex = _texture_dir(tmp_path)
    cfg, jcfg = _configs(nx=32, ny=24, ns=2, max_depth=6)
    ts, tc = tmesh.load_staircase_scene(bvh, tex, cfg.nx, cfg.ny,
                                        device="cpu")
    js, jc = jmesh.load_staircase_scene(bvh, tex, cfg.nx, cfg.ny)
    assert ts.mesh.brute is None and ts.tex_atlas.shape == (9, 12, 16, 3)
    img = render_image(ts, tc, cfg)
    assert_close_images(img, np.asarray(j_render(js, jc, jcfg)))
    np.testing.assert_array_equal(
        img, render_image(ts, tc, cfg.replace(use_bvh=False)))


def test_scene_on_a_cuda_device_needs_the_kernel():
    """The engine passes the mesh to the kernel wrappers, which take the
    plain version only for CPU tensors."""
    ts, tc = tmesh.procedural_staircase_scene(8, 8, device="cpu")
    calls = []
    real = ct.tris_hit_feat

    def spy(origin, *a):
        calls.append(origin.x.device.type)
        return real(origin, *a)

    ct.tris_hit_feat = spy
    try:
        render_image(ts, tc, RenderConfig(nx=8, ny=8, ns=1, max_depth=2))
    finally:
        ct.tris_hit_feat = real
    assert calls and set(calls) == {"cpu"}


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "tpu_pathtracer_torch", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=_ENV)


def test_cli_renders_the_mesh_scenes(tmp_path):
    p = _cli("--scene", "staircase", "--nx", "16", "--ny", "12", "--ns",
             "1", "--max-depth", "3", "--engine", "plain", "--stats",
             "-o", str(tmp_path / "s.png"), "--device", "cpu", cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    assert "shadows" in p.stderr and (tmp_path / "s.png").exists()
    bvh = str(tmp_path / "stairs.bvh")
    jbvh.save_bvh_file(bvh, jmesh.procedural_staircase_scene(8, 8)[0].mesh)
    p = _cli("--scene", bvh, "--texture-dir", _texture_dir(tmp_path),
             "--nx", "12", "--ny", "8", "--ns", "1", "--max-depth", "2",
             "--device", "cpu", cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    obj = tmp_path / "tet.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                   "f 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    p = _cli("--scene", str(obj), "--nx", "12", "--ny", "8", "--ns", "1",
             "--max-depth", "2", "--no-bvh", "--device", "cpu", cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    # a slice-3 scene: the 12k-triangle torus takes the BVH4 tier
    p = _cli("--scene", "zoo-glass", "--nx", "8", "--ny", "6", "--ns", "1",
             "--max-depth", "2", "--engine", "plain", "--stats",
             "--device", "cpu", cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    assert "leaf_visits" in p.stderr
