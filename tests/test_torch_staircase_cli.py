"""The port's staircase path with and without its BVH, and the mesh
scenes through the CLI. Split from ``test_torch_staircase.py``, whose
helpers these tests share."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_pathtracer.models import mesh as jmesh
from tpu_pathtracer.ops import bvh as jbvh
from test_torch_staircase import ROOT, _texture_dir
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.regen import render_image_regen
from tpu_pathtracer_torch.engine.render import render_image
from tpu_pathtracer_torch.models import mesh as tmesh
from torch_threads import one_torch_thread  # noqa: F401

_ENV = {**os.environ, "PYTHONPATH": os.pathsep.join(
    filter(None, [ROOT, os.environ.get("PYTHONPATH")]))}


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "tpu_pathtracer_torch", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=_ENV)


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
