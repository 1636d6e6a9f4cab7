"""The port's NumPy oracle (``tpu_pathtracer_torch/oracle.py``) against the
JAX package's: the same body over the same RNG, so the same scene gives
the same image bit for bit. Scenes are the JAX package's carried across
with ``convert`` (the same arrays in both), and for the scenes whose
factories the port copies array for array (three spheres, random
spheres, the staircase) also the port's own."""

import numpy as np
import pytest

from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.models import mesh as jmesh
from tpu_pathtracer.models import shapes as jshapes
from tpu_pathtracer.models import spheres as jspheres
from tpu_pathtracer.oracle import render_oracle as j_oracle
from test_torch_render import converted
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.models import mesh as tmesh
from tpu_pathtracer_torch.models import spheres as tspheres
from tpu_pathtracer_torch.oracle import render_oracle
from torch_threads import one_torch_thread  # noqa: F401

# name: (JAX factory, port factory or None, factory kwargs, config)
SCENES = {
    "three-sphere": (jspheres.three_sphere_scene,
                     tspheres.three_sphere_scene, {},
                     dict(nx=24, ny=16, ns=2, max_depth=6)),
    "spheres": (jspheres.random_spheres_scene,
                tspheres.random_spheres_scene, {},
                dict(nx=16, ny=12, ns=2, max_depth=5)),
    "staircase": (jmesh.procedural_staircase_scene,
                  tmesh.procedural_staircase_scene, {},
                  dict(nx=16, ny=12, ns=2, max_depth=5)),
    # the port's knot camera differs from the JAX one by float32 ulps
    # (host float32 against XLA), so only the converted knot is compared
    "knot": (jshapes.knot_zoo_scene, None, dict(nu=48, nv=24),
             dict(nx=12, ny=8, ns=1, max_depth=4, textures=False)),
}


def _scenes(name):
    jf, tf, kw, cfg = SCENES[name]
    js, jc = jf(cfg["nx"], cfg["ny"], **kw)
    ref = j_oracle(js, jc, JConfig(**cfg))
    assert np.isfinite(ref).all() and ref.mean() > 0.01
    return js, jc, tf, kw, cfg, ref


@pytest.mark.parametrize("name", sorted(SCENES))
def test_oracle_equals_jax(name):
    js, jc, tf, kw, cfg, ref = _scenes(name)
    img = render_oracle(*converted(js, jc), RenderConfig(**cfg))
    assert img.dtype == ref.dtype and img.shape == ref.shape
    np.testing.assert_array_equal(img, ref)
    if tf is not None:
        own = tf(cfg["nx"], cfg["ny"], device="cpu", **kw)
        np.testing.assert_array_equal(
            render_oracle(*own, RenderConfig(**cfg)), ref)


def test_oracle_imports_no_card_code():
    """The oracle runs on the host beside a render on the card: it imports
    NumPy, the config and the scene constants, and no kernel module."""
    import ast

    import tpu_pathtracer_torch.oracle as mod
    tree = ast.parse(open(mod.__file__).read())
    imported = {n.module if isinstance(n, ast.ImportFrom) else a.name
                for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names}
    assert imported == {"__future__", "numpy", "tpu_pathtracer_torch.config",
                        "tpu_pathtracer_torch.models"}


def test_to_host_renders_the_same_image():
    """``to_host``'s NumPy copy of a scene and camera (what an oracle
    process takes) renders the tensors' image, and pickles."""
    import pickle

    from tpu_pathtracer_torch.oracle import to_host

    cfg = RenderConfig(nx=12, ny=8, ns=1, max_depth=3)
    scene, cam = tmesh.procedural_staircase_scene(12, 8, device="cpu")
    hs, hc = pickle.loads(pickle.dumps((to_host(scene), to_host(cam))))
    assert isinstance(hs.mesh.brute[0], np.ndarray)
    assert isinstance(hc.origin, np.ndarray)
    np.testing.assert_array_equal(render_oracle(hs, hc, cfg),
                                  render_oracle(scene, cam, cfg))
