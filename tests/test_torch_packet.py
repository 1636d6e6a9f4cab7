"""The large-mesh path of the port: the plain heap BVH walk
(ops/cuda_bvh.py, also ``ops.bvh.traverse``) against the JAX package's
heap kernels (``packet_trace`` / ``packet_occluded``, interpret mode, also
the multi-packet kernels of ``packet_packs`` and ``packet_split``) and its
jnp ``traverse``; and forced-packet renders of both engines against the
JAX package's CPU render, by default and under the knobs that pick other
heap kernels (``mx_leaf``, ``regroup``, ``fast_math``).

Tolerances. Hit masks, occlusion and the per-ray node counters against
``traverse`` are exact; winner ids agree except on exact ties (ROADMAP
C-3). t: rtol 2e-6, u and v: atol 1e-5, normals: rtol 2e-6 and atol
1e-6, tu and tv: atol 1e-5 (the JAX package's own packet-kernel bounds:
XLA contracts multiply-adds into FMAs on the CPU, PyTorch does not).
Renders: rmse < 1e-5 against the JAX render, the bound of
``tests/test_bvh4.py:329``; BVH4 on or off and ``sort_rays`` on or off
(accepted, no effect in the port) give the same image bit for bit. Under
``fast_math`` the port's CPU render is the exact render bit for bit (its
plain versions keep the division); the JAX package's interpret-mode
``pl.reciprocal(approx=True)`` rounds its operand to bf16 (about 2^-9,
coarser than the TPU's 2^-14; ROADMAP C-14), so its render is held to the
golden-gate SSIM >= 0.99 and rmse < 1e-2 (measured 0.9989 and 7.5e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_bvh4 import (T_MIN, assert_ids_or_ties, both_meshes, jv,
                             rays, tv)
from test_torch_bvh_mx import assert_hits_match_jax
from test_torch_render import converted
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.engine.regen import _pool_size as j_pool_size
from tpu_pathtracer.engine.render import render_image as j_render
from tpu_pathtracer.models import mesh as jmesh
from tpu_pathtracer.models import shapes as jshapes
from tpu_pathtracer.ops import bvh as jbvh
from tpu_pathtracer.ops.bvh4 import attach_bvh4
from tpu_pathtracer.ops.pallas_bvh import (build_packet_mesh,
                                           packet_occluded, packet_trace)
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine import wavefront as wf
from tpu_pathtracer_torch.engine.regen import _pool_size, render_image_regen
from tpu_pathtracer_torch.engine.render import render_image
from tpu_pathtracer_torch.ops import bvh as tbvh
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh_mx as cmx
from tpu_pathtracer_torch.ops.vec import FLT_MAX
from tpu_pathtracer_torch.utils.golden import rmse, ssim


def test_heap_walk_matches_jax_kernels():
    """Nearest hit and features against ``packet_trace``, any-hit against
    ``packet_occluded`` with a per-lane t_max and dead lanes."""
    jm, tm = both_meshes(2000, seed=0)
    pm = build_packet_mesh(jm)
    o, d = rays(600, seed=1)
    (jt, jtri, ju, jvv, jnx, jny, jnz, jtu, jtv, jmid), _ = packet_trace(
        jv(o), jv(d), FLT_MAX, pm.nodes, pm.blocks, pm.tri_feat,
        pm.cl_first, pm.width, T_MIN, interpret=True, stride=pm.stride,
        cpb=pm.cpb, smem_nodes=pm.smem_nodes)
    tabs = cb.heap_tables(tm)
    np.testing.assert_array_equal(tabs.tri_feat.numpy(),
                                  np.asarray(pm.tri_feat))
    t, tri, cnt = cb.heap_trace(tv(o), tv(d), FLT_MAX, tabs, T_MIN)
    t, tri, u, v, nx, ny, nz, tu, tvv, mid = cb.winner_features(
        tv(o), tv(d), t, tri, tabs.tri_feat)
    jtri, tri = np.asarray(jtri), tri.numpy()
    hit = jtri >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    assert hit.sum() > 100
    assert_ids_or_ties(jm, o, d, tri, jtri, hit)
    same = hit & (tri == jtri)
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(jt)[hit],
                               rtol=2e-6)
    np.testing.assert_array_equal(t.numpy()[~hit], np.float32(FLT_MAX))
    for a, b in ((u, ju), (v, jvv), (tu, jtu), (tvv, jtv)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   atol=1e-5)
    for a, b in ((nx, jnx), (ny, jny), (nz, jnz)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   rtol=2e-6, atol=1e-6)
    np.testing.assert_array_equal(mid.numpy()[same], np.asarray(jmid)[same])
    tot = cnt.sum(1, dtype=torch.int64)
    assert tot[0] > 0 and tot[1] > 0 and tot[2] > 0 and tot[3] == 0
    assert tot[4] >= tot[0] + tot[1]

    tmv = np.where(np.arange(600) % 3 == 0, -1.0, 9.0).astype(np.float32)
    for tmax in (12.0, tmv):
        jocc, _ = packet_occluded(
            jv(o), jv(d), jnp.asarray(tmax), pm.nodes, pm.blocks,
            pm.cl_first, pm.width, T_MIN, interpret=True, stride=pm.stride,
            cpb=pm.cpb, smem_nodes=pm.smem_nodes)
        occ, ocnt = cb.heap_occluded(tv(o), tv(d), torch.as_tensor(tmax),
                                     tabs, T_MIN)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
        if isinstance(tmax, np.ndarray):
            assert bool((ocnt[:, torch.from_numpy(tmax <= 0)] == 0).all())


@pytest.mark.parametrize("is_shadow", [False, True])
def test_traverse_matches_jax_traverse(is_shadow):
    """``ops.bvh.traverse`` is the reference's per-ray walk, as the JAX
    package's jnp ``traverse`` is: the same hits and the same node
    counters, summed over rays."""
    jm, tm = both_meshes(1500, seed=4, ppl=8)
    o, d = rays(500, seed=5)
    tmax = FLT_MAX if not is_shadow else 10.0
    ref = jbvh.traverse(jm, jnp.asarray(o), jnp.asarray(d), T_MIN, tmax,
                        is_shadow=is_shadow)
    got = tbvh.traverse(tm, torch.from_numpy(o), torch.from_numpy(d),
                        T_MIN, tmax, is_shadow=is_shadow)
    ri, gi = np.asarray(ref.tri_id), got.tri_id.numpy()
    hit = ri >= 0
    np.testing.assert_array_equal(gi >= 0, hit)
    assert (got.nodes_both, got.nodes_single) == \
        (int(ref.nodes_both), int(ref.nodes_single))
    if is_shadow:
        return
    assert_ids_or_ties(jm, o, d, gi, ri, hit)
    same = hit & (gi == ri)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=2e-6)
    np.testing.assert_allclose(got.u.numpy()[same], np.asarray(ref.u)[same],
                               atol=1e-5)
    np.testing.assert_allclose(got.v.numpy()[same], np.asarray(ref.v)[same],
                               atol=1e-5)
    # the brute-force oracle finds the same hits
    bf = tbvh.brute_force(tm, torch.from_numpy(o), torch.from_numpy(d),
                          T_MIN, FLT_MAX)
    np.testing.assert_array_equal(bf.tri_id.numpy() >= 0, hit)
    np.testing.assert_array_equal(bf.t.numpy(), got.t.numpy())


def _jax_scene(name):
    """The JAX scene, with BVH4 tables, and a config forced onto the
    packet path (packet_threshold=1)."""
    if name == "knot":
        js, jc = jshapes.knot_zoo_scene(16, 8, nu=48, nv=12,
                                        prims_per_leaf=32)
        kw = dict(nx=16, ny=8, textures=False)
    else:
        js, jc = jmesh.procedural_staircase_scene(16, 12, sub=2)
        kw = dict(nx=16, ny=12)
    js = dataclasses.replace(js, mesh=attach_bvh4(js.mesh, width=32))
    return js, jc, kw


@pytest.mark.parametrize("name", ["knot", "staircase"])
def test_forced_packet_renders_match_jax(name):
    """A small knot and a textured staircase, forced onto the packet path,
    in both engines, BVH4 on and off, ``sort_rays`` on and off, against
    the JAX package's CPU render."""
    js, jc, kw = _jax_scene(name)
    jcfg = JConfig(ns=1, max_depth=3, rays_per_chunk=64, **kw)
    ref = np.asarray(j_render(js, jc, jcfg))
    ts, tc = converted(js, jc)
    cfg = RenderConfig(ns=1, max_depth=3, rays_per_chunk=64,
                       packet_threshold=1, **kw)
    assert wf.mesh_tier(ts, cfg) == "bvh4"
    assert wf.mesh_tier(ts, cfg.replace(bvh4=False)) == "heap"
    base = render_image_regen(ts, tc, cfg)
    assert np.isfinite(base).all() and base.mean() > 0
    assert rmse(base, ref) < 1e-5
    for engine in (render_image_regen, render_image):
        for b4 in (True, False):
            for srt in (True, False):
                img = engine(ts, tc, cfg.replace(bvh4=b4, sort_rays=srt))
                np.testing.assert_array_equal(img, base)


def test_packet_counters_per_ray():
    """The traversal counters of a forced-packet render come from the
    kernels: positive, leaf_pop <= leaf_visits, and 0 on the brute path."""
    js, jc, kw = _jax_scene("knot")
    ts, tc = converted(js, jc)
    cfg = RenderConfig(ns=1, max_depth=3, stats=True, packet_threshold=1,
                       **kw)
    _, s4 = render_image(ts, tc, cfg, report_stats=True)
    _, sh = render_image(ts, tc, cfg.replace(bvh4=False), report_stats=True)
    _, sb = render_image(ts, tc, cfg.replace(packet_threshold=8192),
                         report_stats=True)
    for s in (s4, sh):
        assert s.nodes_both > 0 and s.nodes_single > 0
        assert 0 < s.leaf_visits and 0 <= s.leaf_pop <= s.leaf_visits
    assert s4.leaf_pop > 0 and sh.leaf_pop == 0
    assert sb.nodes_both == sb.nodes_single == sb.leaf_visits == 0
    # the counters do not change the ray accounting
    for k in ("primary", "secondary", "shadows", "shadows_nohit"):
        assert getattr(s4, k) == getattr(sh, k) == getattr(sb, k), k


@pytest.mark.parametrize("engine", [render_image_regen, render_image])
def test_render_stack_overflow_raises(engine):
    """BVH4 tables whose stack_cap understates the tree make a render
    raise, not return a wrong image."""
    js, jc, kw = _jax_scene("knot")
    ts, tc = converted(js, jc)
    cfg = RenderConfig(ns=1, max_depth=2, packet_threshold=1, **kw)
    small = dataclasses.replace(ts.mesh.bvh4, stack_cap=0)
    ts = dataclasses.replace(ts, mesh=dataclasses.replace(ts.mesh,
                                                          bvh4=small))
    with pytest.raises(RuntimeError, match="overflow"):
        engine(ts, tc, cfg)


def test_tiers_knobs_and_pool_size():
    js, jc, kw = _jax_scene("staircase")
    ts, _ = converted(js, jc)
    cfg = RenderConfig(ns=1, max_depth=3, packet_threshold=1, **kw)
    assert wf.mesh_tier(ts, cfg.replace(use_bvh=False)) == "oracle"
    assert wf.mesh_tier(ts, cfg.replace(packet_threshold=8192)) == "brute"
    # the knobs that pick heap kernels, in the JAX package's precedence:
    # BVH4 tables first, then mx_leaf, then regroup
    heap = cfg.replace(bvh4=False)
    for knobs, route in (({"mx_leaf": True}, "heap-mx"),
                         ({"regroup": True}, "heap-rg"),
                         ({"mx_leaf": True, "regroup": True}, "heap-mx"),
                         ({"fast_math": True}, "heap")):
        assert wf.mesh_tier(ts, heap.replace(**knobs)) == route
        assert wf.mesh_tier(ts, cfg.replace(**knobs)) == "bvh4"
    views = {k: wf.make_view(ts, heap.replace(**{k: True}))
             for k in ("mx_leaf", "regroup", "fast_math")}
    assert isinstance(views["mx_leaf"].packet, cmx.MxTables)
    assert isinstance(views["regroup"].packet, cb.HeapTables)
    assert views["fast_math"].fast_math
    assert not views["mx_leaf"].fast_math and not views["regroup"].fast_math
    # fast_math applies to the packet path only: off it the heap walk is
    # the JAX package's exact traverse
    off = heap.replace(fast_math=True, packet_threshold=1 << 20)
    assert not wf.make_view(ts, off).fast_math
    # the JAX package's regen pool on its packet path: 128k lanes
    # textured, 192k not
    n = 1 << 20
    for tex in (True, False):
        jcfg = JConfig(textures=tex, packet_threshold=1,
                       force_feat_kernels=True)
        assert _pool_size(cfg.replace(textures=tex), n, ts) == \
            j_pool_size(jcfg, n, js) == (1 << 17 if tex else 3 << 16)
    assert _pool_size(cfg.replace(packet_threshold=8192), n, ts) == 1 << 15


@pytest.mark.parametrize("packs,split", [(2, False), (4, False), (2, True),
                                         (4, True)])
def test_multipacket_kernels_match_heap_walk(packs, split):
    """K7: the JAX package's multi-packet heap kernels (``packet_packs``,
    ``packet_split``) against the port's heap walk, which computes them:
    hit masks and occlusion equal, winners except exact ties, the rest
    within the XLA-contraction bounds of
    ``test_torch_bvh_mx.assert_hits_match_jax`` (on grazing lanes of this
    soup t moves by up to 4.1e-6 relative, past the rtol 2e-6 of
    ``test_heap_walk_matches_jax_kernels``)."""
    jm, tm = both_meshes(4000, seed=21, ppl=16)
    pm = build_packet_mesh(jm)
    assert pm.smem_nodes and pm.cpb == 1  # the multi-packet kernels run
    o, d = rays(1500, seed=22)
    kw = dict(interpret=True, stride=pm.stride, cpb=pm.cpb,
              smem_nodes=pm.smem_nodes, packs=packs, split=split)
    jouts, _ = packet_trace(jv(o), jv(d), FLT_MAX, pm.nodes, pm.blocks,
                            pm.tri_feat, pm.cl_first, pm.width, T_MIN, **kw)
    tabs = cb.heap_tables(tm)
    t, tri, _ = cb.heap_trace(tv(o), tv(d), FLT_MAX, tabs, T_MIN)
    outs = cb.winner_features(tv(o), tv(d), t, tri, tabs.tri_feat)
    jtri, tri = np.asarray(jouts[1]), tri.numpy()
    hit = jtri >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    assert hit.sum() > 100
    assert_ids_or_ties(jm, o, d, tri, jtri, hit)
    assert_hits_match_jax(jm, o, d, jouts, outs)
    jocc, _ = packet_occluded(jv(o), jv(d), 15.0, pm.nodes, pm.blocks,
                              pm.cl_first, pm.width, T_MIN, **kw)
    occ, _ = cb.heap_occluded(tv(o), tv(d), 15.0, tabs, T_MIN)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


@pytest.mark.parametrize("knobs", [dict(mx_leaf=True),
                                   dict(mx_leaf=True, mx_passes=6),
                                   dict(regroup=True),
                                   dict(fast_math=True)],
                         ids=["mx_leaf", "mx_leaf-6", "regroup", "fast_math"])
def test_knob_renders_match_jax(knobs):
    """A small knot forced onto the heap kernels, under each knob that
    picks another heap kernel, in both engines, against the JAX package's
    CPU render with the same config (its interpret-mode kernels)."""
    js, jc, kw = _jax_scene("knot")
    base = dict(ns=1, max_depth=3, rays_per_chunk=64, packet_threshold=1,
                bvh4=False, **kw)
    ref = np.asarray(j_render(js, jc, JConfig(force_feat_kernels=True,
                                              **base, **knobs)))
    ts, tc = converted(js, jc)
    cfg = RenderConfig(**base)
    img = render_image(ts, tc, cfg.replace(**knobs))
    np.testing.assert_array_equal(
        render_image_regen(ts, tc, cfg.replace(**knobs)), img)
    assert np.isfinite(img).all() and img.mean() > 0
    if "fast_math" in knobs:
        np.testing.assert_array_equal(img, render_image(ts, tc, cfg))
        assert ssim(img, ref) >= 0.99 and rmse(img, ref) < 1e-2
    else:
        assert rmse(img, ref) < 1e-5
