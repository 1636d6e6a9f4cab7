"""The port's decision experiments on the scenes other than the knot
(``crossover``, ``zoo_table``, ``terrain_big_ab``,
``sah_vs_median_stairs``, ``converged_oracle``), run on the CPU at tiny
sizes: each arm's tier equals the JAX package's dispatch for the same
JAX-built scene and config, the arms that compute one function agree,
one arm of each equals the JAX package's regen render of the same scene
and samples, and the converged oracle's check passes within its bounds
and fails outside them. Bounds and the JAX reference as in
``tests/test_torch_experiments_e2e.py``; the spheres against the JAX
render at ``tests/test_torch_render.py``'s image bounds.
"""

import dataclasses
import functools

import numpy as np
import pytest

from test_torch_experiments_e2e import (RENDER_RMSE, TINY, jax_image,
                                        jax_tier)
from test_torch_render import assert_close_images
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.models import mesh as jmesh
from tpu_pathtracer.models import shapes as jshapes
from tpu_pathtracer.models import spheres as jspheres
from tpu_pathtracer.ops import bvh4 as jb4
from tpu_pathtracer_torch.experiments import (converged_oracle, crossover,
                                              sah_vs_median_stairs,
                                              terrain_big_ab, zoo_table)
from tpu_pathtracer_torch.models.shapes import terrain_zoo_scene
from tpu_pathtracer_torch.models.spheres import three_sphere_scene
from tpu_pathtracer_torch.ops.bvh4 import attach_bvh4
from tpu_pathtracer_torch.utils.golden import rmse
from torch_threads import one_torch_thread  # noqa: F401

REF = JConfig(ns=1, textures=False, **TINY)


@functools.lru_cache(maxsize=None)
def jtorus(material="coat"):
    """crossover's torus (16,384 slots at 32 a leaf), in the JAX package."""
    return jshapes.model_zoo_scene(TINY["nx"], TINY["ny"], material=material,
                                   **crossover.SCENE)


@functools.lru_cache(maxsize=None)
def cross():
    return crossover.measure("cpu", 1, config=dict(
        TINY, textures=False, rays_per_chunk=65536))


def test_crossover_arms_take_brute_and_bvh4():
    r = cross()
    assert [x.tier for x in r.values()] == \
        [jax_tier(jtorus()[0], x.cfg) for x in r.values()] == \
        ["brute", "bvh4"]
    assert rmse(r["brute"].image, r["packet"].image) < RENDER_RMSE


def test_crossover_matches_jax():
    assert rmse(cross()["brute"].image,
                jax_image(*jtorus(), 1, 0, REF)) < RENDER_RMSE


@functools.lru_cache(maxsize=None)
def zoo():
    return zoo_table.measure("cpu", 1, config=dict(TINY, textures=False),
                             scene_kw=crossover.SCENE)


def test_zoo_table_tiers_follow_jax():
    r = zoo()
    assert list(r) == list(zoo_table.MATERIALS)
    for mat, x in r.items():
        assert x.tier == jax_tier(jtorus(mat)[0], x.cfg) == "bvh4"
        assert np.isfinite(x.image).all() and x.mean > 0
    assert len({round(x.mean, 6) for x in r.values()}) == 4


def test_zoo_table_matches_jax():
    assert rmse(zoo()["coat"].image, jax_image(*jtorus(), 1, 0, REF)) < \
        RENDER_RMSE


TERRAIN = dict(n=48, struts=40)


def tiny_terrain(nx, ny, device):
    """A small terrain with quant BVH4 tables forced, as terrain-big
    carries them."""
    scene, cam = terrain_zoo_scene(nx, ny, device=device, **TERRAIN)
    return dataclasses.replace(
        scene, mesh=attach_bvh4(scene.mesh, quant=True)), cam


@functools.lru_cache(maxsize=None)
def jterrain(quant):
    js, jc = jshapes.terrain_zoo_scene(TINY["nx"], TINY["ny"], **TERRAIN)
    if quant:
        js = dataclasses.replace(js, mesh=jb4.attach_bvh4(js.mesh,
                                                          quant=True))
    return js, jc


@functools.lru_cache(maxsize=None)
def terrain():
    return terrain_big_ab.measure("cpu", 1, config=dict(
        TINY, textures=False, packet_threshold=1), factory=tiny_terrain)


def test_terrain_big_ab_tiers_tables_and_arms_agree():
    build, tables, r = terrain()
    jq = jterrain(True)[0].mesh.bvh4
    assert build > 0
    assert tables == dict(quant=True, nodes=jq.n_nodes,
                          kb=(jq.bounds.size + jq.refs.size) * 4 >> 10,
                          clusters=jq.n_clusters, stack_cap=jq.stack_cap)
    assert [x.tier for x in r.values()] == \
        [jax_tier(jterrain(True)[0], x.cfg) for x in r.values()] == \
        ["quant-bvh4", "heap", "quant-bvh4"]
    assert all(len(x.times) == terrain_big_ab.REPS for x in r.values())
    assert rmse(r["heap"].image, r["bvh4q"].image) < RENDER_RMSE
    np.testing.assert_array_equal(r["bvh4q"].image, r["bvh4q2"].image)


def test_terrain_big_ab_matches_jax():
    assert rmse(terrain()[2]["heap"].image,
                jax_image(*jterrain(False), 1, 0, REF)) < RENDER_RMSE


STAIRS = dict(prims_per_leaf=16, sub=4)


@functools.lru_cache(maxsize=None)
def stairs():
    return sah_vs_median_stairs.measure_stairs(
        "cpu", 1, dict(TINY, rays_per_chunk=65536, packet_threshold=1),
        STAIRS)


def test_sah_vs_median_stairs_tiers_and_arms_agree():
    from tpu_pathtracer import native as jnat
    res = stairs()
    saved = jnat._TRIED, jnat._LIB
    try:
        jnat._TRIED, jnat._LIB = True, None
        jmed, _ = jmesh.procedural_staircase_scene(TINY["nx"], TINY["ny"],
                                                   **STAIRS)
    finally:
        jnat._TRIED, jnat._LIB = saved
    jsah, _ = jmesh.procedural_staircase_scene(TINY["nx"], TINY["ny"],
                                               **STAIRS)
    for js, x in zip((jmed, jsah), res.arms.values()):
        assert x.tier == jax_tier(js, x.cfg) == "heap"
    assert rmse(res.arms["median"].image, res.arms["sah"].image) < \
        RENDER_RMSE


def test_sah_vs_median_stairs_matches_jax():
    js, jc = jmesh.procedural_staircase_scene(TINY["nx"], TINY["ny"],
                                              **STAIRS)
    ref = jax_image(js, jc, 1, 0, JConfig(ns=1, **TINY))
    assert rmse(stairs().arms["sah"].image, ref) < RENDER_RMSE


class InlinePool:
    """``apply_async`` run at once in this process."""

    class Done:
        def __init__(self, value):
            self.value = value

        def get(self):
            return self.value

    def apply_async(self, fn, args):
        return self.Done(fn(*args))


SPHERES = dict(nx=48, ny=32)
ONE = (("three-sphere", three_sphere_scene, 4),)


@functools.lru_cache(maxsize=None)
def converged():
    return converged_oracle.finish(converged_oracle.start(
        "cpu", InlinePool(), spp=2, size=SPHERES, scenes=ONE))


def test_converged_oracle_within_bounds():
    c = converged()["three-sphere"]
    assert c.reading.tier == "spheres" == jax_tier(
        jspheres.three_sphere_scene(48, 32)[0], c.reading.cfg)
    assert c.rmse < converged_oracle.RMSE_TOL
    assert c.ssim >= converged_oracle.SSIM_MIN
    assert c.oracle_s > 0 and c.reading.spp == 2


def test_converged_oracle_fails_outside_bounds():
    (p,) = converged_oracle.start("cpu", InlinePool(), spp=1,
                                  size=dict(nx=16, ny=12), scenes=ONE)
    dark = p._replace(job=InlinePool.Done((np.zeros((12, 16, 3),
                                                    np.float32), 0.0)))
    with pytest.raises(AssertionError, match="converged oracle FAILED"):
        converged_oracle.finish([dark])


def test_converged_oracle_matches_jax():
    js, jc = jspheres.three_sphere_scene(48, 32)
    cfg = JConfig(ns=2, max_depth=4, **SPHERES)
    assert_close_images(converged()["three-sphere"].reading.image,
                        jax_image(js, jc, 2, 0, cfg))
