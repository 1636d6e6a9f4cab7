"""The port's ``utils/profiling.py``: ``measure`` as the JAX package's
test of it (tests/test_render_golden.py:150), and ``trace`` writing its
Chrome trace."""

import json
import os

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.regen import render_image_regen
from tpu_pathtracer_torch.models.spheres import three_sphere_scene
from tpu_pathtracer_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401


def test_profiling_measure_reports_rays():
    cfg = RenderConfig(nx=16, ny=8, ns=2, max_depth=4, rays_per_chunk=64)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    m = profiling.measure(scene, cam, cfg, count_rays=True)
    assert m.seconds > 0
    assert m.paths == 16 * 8 * 2
    assert m.rays >= m.paths  # at least one ray per path
    assert m.mrays_per_sec is not None and m.mrays_per_sec > 0
    assert "Mpaths/s" in repr(m)
    r = profiling.measure(scene, cam, cfg, renderer=render_image_regen)
    assert r.rays is None and r.mrays_per_sec is None and r.seconds > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    cfg = RenderConfig(nx=8, ny=8, ns=1, max_depth=2)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    out = str(tmp_path / "tr")
    with profiling.trace(out) as d:
        render_image_regen(scene, cam, cfg)
    assert d == out
    with open(os.path.join(out, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
