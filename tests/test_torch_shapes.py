"""The port's procedural shapes, model-zoo scenes and material presets
(models/shapes.py, models/presets.py) against the JAX package's, at small
sizes: every array element for element (exact), the cameras to 1e-5 (the
bound of the sphere scenes' camera test)."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_render import jax_camera_fields, jax_fields
from tpu_pathtracer.models import presets as jpresets
from tpu_pathtracer.models import shapes as jshapes
from tpu_pathtracer_torch.models import presets as tpresets
from tpu_pathtracer_torch.models import shapes as tshapes
from tpu_pathtracer_torch.models.scene import MeshData, Scene
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {
    "torus": ("torus_mesh", dict(nu=8, nv=6)),
    "knot": ("torus_knot_mesh", dict(nu=24, nv=8)),
    "terrain": ("terrain_mesh", dict(n=16, struts=20)),
    "rocks": ("rock_pile_mesh", dict(n_big=2, n_small=2)),
}
SCENES = {
    "zoo-coat": ("model_zoo_scene", dict(material="coat", nu=8, nv=6)),
    "zoo-diffuse": ("model_zoo_scene", dict(material="diffuse", nu=8,
                                            nv=6)),
    "zoo-glass": ("model_zoo_scene", dict(material="glass", nu=8, nv=6)),
    "zoo-sss": ("model_zoo_scene", dict(material="sss", nu=8, nv=6)),
    "knot": ("knot_zoo_scene", dict(nu=24, nv=8, prims_per_leaf=16)),
    "terrain": ("terrain_zoo_scene", dict(n=16, struts=20)),
    "rocks": ("rocks_zoo_scene", dict(n_big=1, n_small=1)),
}


def test_presets_equal_jax():
    assert set(tpresets.ALL_PRESETS) == set(jpresets.ALL_PRESETS)
    for name, fn in tpresets.ALL_PRESETS.items():
        assert fn() == jpresets.ALL_PRESETS[name](), name
    assert tpresets.hex_color(0x511845) == jpresets.hex_color(0x511845)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_shape_meshes_equal_jax(name):
    fn, kw = MESHES[name]
    got = getattr(tshapes, fn)(**kw)
    want = getattr(jshapes, fn)(**kw)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_zoo_scenes_equal_jax(name):
    fn, kw = SCENES[name]
    ts, tc = getattr(tshapes, fn)(24, 16, device="cpu", **kw)
    js, jc = getattr(jshapes, fn)(24, 16, **kw)
    want = jax_fields(js)
    for f in dataclasses.fields(Scene):
        got, exp = getattr(ts, f.name), want[f.name]
        if f.name == "materials":
            for k, v in exp.items():
                np.testing.assert_array_equal(getattr(got, k).numpy(), v)
        elif f.name == "mesh":
            for g in dataclasses.fields(MeshData):
                a, b = getattr(got, g.name), exp[g.name]
                if isinstance(a, torch.Tensor):
                    np.testing.assert_array_equal(a.numpy(), b,
                                                  err_msg=g.name)
                elif g.name == "brute":
                    assert (a is None) == (b is None)
                    for x, y in zip(a or (), b or ()):
                        np.testing.assert_array_equal(x.numpy(), y)
                elif g.name != "bvh4":  # small meshes carry none
                    assert a == b, g.name
            assert got.bvh4 is None and exp["bvh4"] is None
        elif isinstance(exp, np.ndarray):
            np.testing.assert_array_equal(got.numpy(), exp, err_msg=f.name)
        else:
            assert got == exp, f.name
    for k, v in jax_camera_fields(jc).items():
        np.testing.assert_allclose(getattr(tc, k).numpy(), v, atol=1e-5)
