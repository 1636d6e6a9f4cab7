"""The port's staircase path against the JAX engines and the NumPy
oracle: renders on the feature-kernel path, the oracle's bounds, rays
outside the mesh's box, NEE among spheres and a loaded ``.bvh`` scene.
Split from ``test_torch_staircase.py``, whose helpers and bounds these
tests share."""

import numpy as np
import pytest

from tpu_pathtracer.camera import make_camera as j_make_camera
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.engine.regen import render_image_regen as j_regen
from tpu_pathtracer.engine.render import render_image as j_render
from tpu_pathtracer.models import mesh as jmesh
from tpu_pathtracer.models import scene as jsc
from tpu_pathtracer.ops import bvh as jbvh
from tpu_pathtracer.oracle import render_oracle
from test_torch_render import converted
from test_torch_staircase import _configs, _texture_dir, assert_close_images
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.regen import render_image_regen
from tpu_pathtracer_torch.engine.render import render_image
from tpu_pathtracer_torch.models import mesh as tmesh
from tpu_pathtracer_torch.utils import golden
from torch_threads import one_torch_thread  # noqa: F401


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
