"""End-to-end parity of the port's staircase path (triangle mesh, image
textures, NEE shadow rays): against the JAX engines on the feature-kernel
path (``force_feat_kernels=True``, the path a TPU runs for a small mesh),
against the independent NumPy oracle and the committed golden, and its
own invariants. The tests are spread over three files so that the test
runner's workers share them: this one (the NEE and texture variants, the
stats, the golden and the engines' agreement), ``test_torch_staircase_jax.py``
(renders against the JAX engines and the oracle) and
``test_torch_staircase_cli.py`` (BVH on and off, the CLI); the helpers
live here."""

import os

import numpy as np
import pytest

from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.engine.render import render_image as j_render
from tpu_pathtracer.models import mesh as jmesh
from test_torch_render import converted
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.regen import render_image_regen
from tpu_pathtracer_torch.engine.render import render_image
from tpu_pathtracer_torch.models import mesh as tmesh
from tpu_pathtracer_torch.ops import cuda_tris as ct
from tpu_pathtracer_torch.utils import golden
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _texture_dir(path):
    from PIL import Image

    rng = np.random.RandomState(3)
    for name in tmesh.STAIRCASE_TEXTURE_NAMES:
        px = rng.randint(0, 256, (12, 16, 3)).astype(np.uint8)
        Image.fromarray(px, "RGB").save(os.path.join(path, name))
    return str(path)


def test_scene_on_a_cuda_device_needs_the_kernel():
    """The engine passes the mesh to the kernel wrappers, which take the
    plain version only for CPU tensors."""
    ts, tc = tmesh.procedural_staircase_scene(8, 8, device="cpu")
    calls = []
    real = ct.tris_hit_feat

    def spy(origin, *a, **kw):
        calls.append(origin.x.device.type)
        return real(origin, *a, **kw)

    ct.tris_hit_feat = spy
    try:
        render_image(ts, tc, RenderConfig(nx=8, ny=8, ns=1, max_depth=2))
    finally:
        ct.tris_hit_feat = real
    assert calls and set(calls) == {"cpu"}

