"""The port's checkpoints (``tpu_pathtracer_torch/utils/checkpoint.py``):
the tests of ``tests/test_regen_checkpoint.py:181-225`` through the port,
the ``CKPT_00.02`` file and the scene fingerprint held against the JAX
package's, and a render resumed across the two packages."""

import dataclasses
import struct

import numpy as np
import pytest
import torch

from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.models import mesh as jmesh
from tpu_pathtracer.models import scene as jsc
from tpu_pathtracer.models import spheres as jspheres
from tpu_pathtracer.ops import bvh as jbvh
from tpu_pathtracer.utils import checkpoint as jck
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.regen import render_image_regen
from tpu_pathtracer_torch.models import mesh as tmesh
from tpu_pathtracer_torch.models import scene as tsc
from tpu_pathtracer_torch.models import spheres as tspheres
from tpu_pathtracer_torch.ops import bvh as tbvh
from tpu_pathtracer_torch.utils import checkpoint as ck


def test_checkpoint_roundtrip(tmp_path):
    buf = np.random.RandomState(0).rand(8, 12, 3).astype(np.float32)
    p = str(tmp_path / "c.ckpt")
    ck.save_checkpoint(p, buf, 7, fingerprint=123)
    back, done, fp = ck.load_checkpoint(p)
    assert done == 7
    assert fp == 123
    np.testing.assert_array_equal(back, buf)
    assert ck.load_checkpoint(str(tmp_path / "missing.ckpt")) is None
    with open(p, "rb") as f:
        assert f.read(10) == b"CKPT_00.02"


def test_checkpoint_rejects_mismatch(tmp_path):
    cfg = RenderConfig(nx=16, ny=8, ns=2, max_depth=4, rays_per_chunk=64)
    scene, cam = tspheres.three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    p = str(tmp_path / "m.ckpt")
    ck.render_with_checkpoints(scene, cam, cfg, p, batch=2)
    # more samples done than the new config asks for → refuse
    with pytest.raises(ValueError, match="samples done"):
        ck.render_with_checkpoints(scene, cam, cfg.replace(ns=1), p, batch=1)
    # different scene → fingerprint mismatch
    scene2 = dataclasses.replace(
        scene, light_color=torch.tensor((9.0, 9.0, 9.0)))
    with pytest.raises(ValueError, match="fingerprint"):
        ck.render_with_checkpoints(scene2, cam, cfg.replace(ns=4), p,
                                   batch=2)
    # different resolution → refuse
    with pytest.raises(ValueError, match="resolution"):
        ck.render_with_checkpoints(scene, cam, cfg.replace(nx=8, ns=4), p)


def test_render_with_checkpoints_resume(tmp_path):
    cfg = RenderConfig(nx=24, ny=16, ns=6, max_depth=5, rays_per_chunk=256)
    scene, cam = tspheres.three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    p = str(tmp_path / "r.ckpt")

    # straight checkpointed run, the same batch
    full = ck.render_with_checkpoints(scene, cam, cfg, p + ".a", batch=2)
    # interrupted run: 2 batches of 2, "crash", resume for the rest
    calls = []
    ck.render_with_checkpoints(
        scene, cam, cfg.replace(ns=4), p, batch=2,
        progress=lambda d, t: calls.append(d))
    assert calls == [2, 4]
    resumed = ck.render_with_checkpoints(scene, cam, cfg, p, batch=2)
    np.testing.assert_array_equal(full, resumed)
    # a straight render sums each pixel's samples in another grouping
    np.testing.assert_allclose(full, render_image_regen(scene, cam, cfg),
                               atol=1e-4)


def test_v1_checkpoint_loads_unchecked(tmp_path):
    buf = np.random.RandomState(1).rand(4, 6, 3).astype(np.float32)
    p = str(tmp_path / "v1.ckpt")
    with open(p, "wb") as f:
        f.write(b"CKPT_00.01" + struct.pack("<iii", 6, 4, 3) + buf.tobytes())
    back, done, fp = ck.load_checkpoint(p)
    assert done == 3 and fp is None
    np.testing.assert_array_equal(back, buf)
    with open(p, "wb") as f:
        f.write(b"CKPT_99.99")
    with pytest.raises(ValueError, match="header"):
        ck.load_checkpoint(p)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_across_packages(tmp_path, writer):
    """A file written by either package reads back equal in the other,
    byte for byte the same file."""
    buf = np.random.RandomState(2).rand(5, 7, 3).astype(np.float32)
    a, b = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    save, load = ((jck.save_checkpoint, ck.load_checkpoint)
                  if writer == "jax" else
                  (ck.save_checkpoint, jck.load_checkpoint))
    save(a, buf, 5, fingerprint=2 ** 32 - 1)
    back, done, fp = load(a)
    assert (done, fp) == (5, 2 ** 32 - 1)
    np.testing.assert_array_equal(back, buf)
    (ck.save_checkpoint if writer == "jax" else jck.save_checkpoint)(
        b, buf, 5, fingerprint=2 ** 32 - 1)
    assert open(a, "rb").read() == open(b, "rb").read()


SCENES = {"three-sphere": (jspheres.three_sphere_scene,
                           tspheres.three_sphere_scene),
          "staircase": (jmesh.procedural_staircase_scene,
                        tmesh.procedural_staircase_scene)}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fingerprint_equals_jax(name):
    jf, tf = SCENES[name]
    kw = dict(nx=16, ny=8, ns=2, max_depth=4)
    fp = ck.scene_fingerprint(tf(16, 8, device="cpu")[0], RenderConfig(**kw))
    assert fp == jck.scene_fingerprint(jf(16, 8)[0], JConfig(**kw))
    # the config key counts too
    assert fp != ck.scene_fingerprint(tf(16, 8, device="cpu")[0],
                                      RenderConfig(**{**kw, "max_depth": 5}))


def test_fingerprint_leaves_out_the_bvh4_tables():
    """The one part of a scene whose digest cannot match: a mesh's BVH4
    tables. The JAX package's carry TPU DMA ``blocks`` the port does not
    build, so the port leaves the tables out (they are built from the
    heap mesh the digest covers). Without them both packages agree."""
    rng = np.random.RandomState(3)
    v0 = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cfg = dict(nx=8, ny=8, ns=1, max_depth=2)
    jm = jbvh.build_bvh(v0, v1, v2, builder="median", bvh4=True)
    tm = tbvh.build_bvh(v0, v1, v2, builder="median", bvh4=True,
                        device="cpu")
    assert jm.bvh4 is not None and tm.bvh4 is not None
    jmat = jsc.make_materials([dict(type=jsc.DIFFUSE, color=(0.5,) * 3)])
    tmat = tsc.make_materials([dict(type=tsc.DIFFUSE, color=(0.5,) * 3)],
                              "cpu")
    js = jsc.make_scene(jmat, mesh=jm)
    ts = tsc.make_scene(tmat, mesh=tm)
    fp = ck.scene_fingerprint(ts, RenderConfig(**cfg))
    assert fp == ck.scene_fingerprint(
        dataclasses.replace(ts, mesh=dataclasses.replace(tm, bvh4=None)),
        RenderConfig(**cfg))
    no_bvh4 = dataclasses.replace(js, mesh=dataclasses.replace(jm,
                                                               bvh4=None))
    assert fp == jck.scene_fingerprint(no_bvh4, JConfig(**cfg))
    assert fp != jck.scene_fingerprint(js, JConfig(**cfg))


def test_resume_a_jax_checkpoint(tmp_path):
    """A render the JAX package stopped at 2 of 4 samples is resumed by the
    port: the fingerprints agree, and the image is the straight port
    render's within the XLA-contraction bound of the port's JAX tests."""
    cfg = dict(nx=16, ny=8, ns=4, max_depth=3, rays_per_chunk=64)
    js, jc = jspheres.three_sphere_scene(16, 8)
    ts, tc = tspheres.three_sphere_scene(16, 8, device="cpu")
    p = str(tmp_path / "x.ckpt")
    jck.render_with_checkpoints(js, jc, JConfig(**{**cfg, "ns": 2}), p,
                                batch=2)
    img = ck.render_with_checkpoints(ts, tc, RenderConfig(**cfg), p,
                                     batch=2)
    assert ck.load_checkpoint(p)[1] == 4
    np.testing.assert_allclose(
        img, render_image_regen(ts, tc, RenderConfig(**cfg)), atol=1e-4)
