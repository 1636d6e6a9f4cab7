"""The CUDA sphere (exact and mx), triangle, heap-BVH (exact and
fast_math, MXU-leaf, regrouped, packet walk) and BVH4 kernels, and the
probes' kernels (K13-K16), against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

(``--noconftest``: the suite's conftest configures JAX.)
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.regen import render_image_regen
from tpu_pathtracer_torch.experiments import dma_probe as dm
from tpu_pathtracer_torch.experiments import dual_probe as dp
from tpu_pathtracer_torch.experiments import iter_ablate as ia
from tpu_pathtracer_torch.experiments import leafmt_probe as lm
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import bvh as tbvh
from tpu_pathtracer_torch.ops import bvh4 as tb4
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh4 as cb4
from tpu_pathtracer_torch.ops import cuda_bvh_mr as cmr
from tpu_pathtracer_torch.ops import cuda_bvh_mx as cmx
from tpu_pathtracer_torch.ops import cuda_bvh_rg as crg
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops import cuda_tris as ct
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

T_MIN = 0.01


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, n=50_000, s=700, seed=0):
    """Rays and spheres on ``dev``; s = 700 spans two shared-memory
    tiles of the kernel."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.uniform(-8, 8, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = rng.uniform(-10, 10, (s, 3)).astype(np.float32)
    r = rng.uniform(0.2, 1.2, s).astype(np.float32)
    r[::50] = -1.0  # padding-style slots never win
    feat = rng.uniform(-3, 3, (s, 18)).astype(np.float32)
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(dev)
                       for k in range(3)))
    return (v(o), v(d), v(c), torch.from_numpy(r).to(dev),
            torch.from_numpy(feat).to(dev))


@pytest.mark.gpu
def test_features_mode_bit_equal(dev):
    o, d, c, r, feat = _inputs(dev)
    before = cs.LAUNCHES
    tk, ik, fk = cs.spheres_hit_feat(o, d, c, r, feat, T_MIN, FLT_MAX)
    tp, ip, fp = cs._spheres_hit_feat_ref(o, d, c, r, feat, T_MIN, FLT_MAX)
    torch.cuda.synchronize()
    assert cs.LAUNCHES == before + 1
    # -fmad=false and the plain version's operation order: bit-equal
    assert torch.equal(ik, ip) and torch.equal(tk, tp)
    assert torch.equal(torch.stack(fk), torch.stack(fp))
    assert (ik >= 350).any() and (ik >= 0).float().mean() > 0.3
    assert not torch.isin(ik, torch.arange(0, 700, 50, device=dev)).any()


@pytest.mark.gpu
@pytest.mark.parametrize("per_ray_tmax", [False, True])
def test_nearest_and_anyhit_modes_bit_equal(dev, per_ray_tmax):
    o, d, c, r, _ = _inputs(dev, seed=1)
    tm = (torch.linspace(0.5, 30.0, o.x.shape[0], device=dev)
          if per_ray_tmax else FLT_MAX)
    tk, ik = cs.spheres_hit_soa(o, d, c, r, T_MIN, tm)
    tp, ip = cs._spheres_hit_ref(o, d, c, r, T_MIN, tm)
    assert torch.equal(ik, ip) and torch.equal(tk, tp)
    ok = cs.spheres_anyhit_soa(o, d, c, r, T_MIN, tm)
    op = cs._spheres_anyhit_ref(o, d, c, r, T_MIN, tm)
    assert torch.equal(ok, op) and torch.equal(ok, ip >= 0)


@pytest.mark.gpu
@pytest.mark.parametrize("per_ray_tmax", [False, True])
def test_spheres_mx_bit_equal(dev, per_ray_tmax):
    """K2 and K3 (``mx=True``) against their plain versions: t, idx,
    features and occlusion bit-equal (the split products are exact in
    FP32 and summed in the plain version's order)."""
    o, d, c, r, feat = _inputs(dev, seed=2)
    tm = (torch.linspace(0.5, 30.0, o.x.shape[0], device=dev)
          if per_ray_tmax else FLT_MAX)
    before = dict(cs.MX_LAUNCHES), cs.LAUNCHES
    tk, ik, fk = cs.spheres_hit_feat(o, d, c, r, feat, T_MIN, tm, mx=True)
    tp, ip, fp = cs._spheres_hit_feat_ref(o, d, c, r, feat, T_MIN, tm,
                                          mx=True)
    ok = cs.spheres_anyhit_soa(o, d, c, r, T_MIN, tm, mx=True)
    op = cs._spheres_anyhit_ref(o, d, c, r, T_MIN, tm, mx=True)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip) and torch.equal(tk, tp)
    assert torch.equal(torch.stack(fk), torch.stack(fp))
    assert torch.equal(ok, op) and torch.equal(ok, ik >= 0)
    assert (ik >= 0).float().mean() > 0.1
    assert not torch.isin(ik, torch.arange(0, 700, 50, device=dev)).any()
    assert cs.MX_LAUNCHES["features"] == before[0]["features"] + 1
    assert cs.MX_LAUNCHES["any_hit"] == before[0]["any_hit"] + 1
    assert cs.LAUNCHES == before[1]


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    o, d, c, r, feat = _inputs(dev, n=64, s=8)
    with pytest.raises(TypeError):
        cs.spheres_hit_soa(V3(o.x.double(), o.y, o.z), d, c, r, T_MIN,
                           FLT_MAX)
    strided = torch.zeros(128, device=dev)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        cs.spheres_hit_soa(V3(strided, o.y, o.z), d, c, r, T_MIN, FLT_MAX)
    with pytest.raises(ValueError, match="on cpu"):
        cs.spheres_hit_feat(o, d, c, r, feat.cpu(), T_MIN, FLT_MAX)


@pytest.mark.gpu
def test_small_render_kernel_equals_plain(dev):
    cfg = RenderConfig(nx=48, ny=32, ns=2, max_depth=8)
    scene, cam = random_spheres_scene(cfg.nx, cfg.ny, device=dev)
    cs.LAUNCHES = 0
    img = render_image_regen(scene, cam, cfg)
    assert cs.LAUNCHES > 0
    with mock.patch.object(cs, "spheres_hit_feat", cs._spheres_hit_feat_ref):
        ref = render_image_regen(scene, cam, cfg)
    np.testing.assert_array_equal(img, ref)


def _tri_inputs(dev, n=50_000, t=700, seed=0):
    """Rays and triangles on ``dev``: t = 700 spans two shared-memory
    tiles of the kernel; every 50th slot is an +inf sentinel, and every
    7th ray is a dead lane (t_max = -1)."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.uniform(-8, 8, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v0 = rng.uniform(-8, 8, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    v0[::50] = v1[::50] = v2[::50] = np.inf
    feat = rng.uniform(-3, 3, (t, 26)).astype(np.float32)
    tm = np.full(n, FLT_MAX, np.float32)
    tm[::7] = -1.0
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(dev)
                       for k in range(3)))
    tv0, tv1, tv2 = v(v0), v(v1), v(v2)
    e1, e2 = tv1 - tv0, tv2 - tv0
    return (v(o), v(d), tv0, e1, e2, e1.cross(e2),
            torch.from_numpy(feat).to(dev), torch.from_numpy(tm).to(dev))


@pytest.mark.gpu
def test_tris_features_mode_bit_equal(dev):
    o, d, v0, e1, e2, nrm, feat, tm = _tri_inputs(dev)
    before = ct.LAUNCHES["features"]
    k = ct.tris_hit_feat(o, d, v0, e1, e2, nrm, feat, T_MIN, tm)
    p = ct._tris_hit_feat_ref(o, d, v0, e1, e2, nrm, feat, T_MIN, tm)
    torch.cuda.synchronize()
    assert ct.LAUNCHES["features"] == before + 1
    # -fmad=false and the plain version's operation order: bit-equal
    for a, b in zip(k[:4], p[:4]):
        assert torch.equal(a, b)
    assert torch.equal(torch.stack(k[4]), torch.stack(p[4]))
    idx = k[1]
    assert (idx >= 512).any() and (idx >= 0).float().mean() > 0.1
    assert not torch.isin(idx, torch.arange(0, 700, 50, device=dev)).any()
    assert (idx[::7] == -1).all()  # dead lanes stay inert


@pytest.mark.gpu
@pytest.mark.parametrize("per_ray_tmax", [False, True])
def test_tris_nearest_and_anyhit_modes_bit_equal(dev, per_ray_tmax):
    o, d, v0, e1, e2, nrm, _, tm = _tri_inputs(dev, seed=1)
    if per_ray_tmax:
        tm = torch.where(tm > 0, torch.linspace(0.5, 30.0, tm.numel(),
                                                device=dev), tm)
    args = (o, d, v0, e1, e2, nrm, T_MIN, tm)
    k = ct.tris_hit_soa(*args)
    p = ct._tris_hit_ref(*args)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    occ_k = ct.tris_anyhit_soa(*args)
    assert torch.equal(occ_k, ct._tris_anyhit_ref(*args))
    assert torch.equal(occ_k, k[1] >= 0)
    assert not occ_k[::7].any()


@pytest.mark.gpu
def test_small_staircase_kernel_equals_plain(dev):
    cfg = RenderConfig(nx=48, ny=32, ns=2, max_depth=8)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny, device=dev)
    for key in ct.LAUNCHES:
        ct.LAUNCHES[key] = 0
    img = render_image_regen(scene, cam, cfg)
    assert ct.LAUNCHES["features"] > 0 and ct.LAUNCHES["any_hit"] > 0
    with mock.patch.object(ct, "tris_hit_feat", ct._tris_hit_feat_ref), \
            mock.patch.object(ct, "tris_anyhit_soa", ct._tris_anyhit_ref):
        ref = render_image_regen(scene, cam, cfg)
    np.testing.assert_array_equal(img, ref)


def _bvh_inputs(dev, n=40_000, t=20_000, seed=0, ppl=16):
    """A random triangle soup (heap BVH, ``ppl`` triangles a leaf) and
    rays on ``dev``; every 7th ray is a dead lane (t_max = -1)."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-10, 10, (t, 3)).astype(np.float32)
    v1 = base + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v2 = base + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    mesh = tbvh.build_bvh(base, v1, v2, prims_per_leaf=ppl, bvh4=False,
                          device=dev)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.uniform(-8, 8, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.where(np.arange(n) % 7 == 0, -1.0,
                  rng.uniform(3, 30, n)).astype(np.float32)
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(dev)
                       for k in range(3)))
    return mesh, v(o), v(d), torch.from_numpy(tm).to(dev)


def _assert_walks_equal(trace, occluded, trace_ref, occluded_ref, launches,
                        o, d, tm, tabs):
    before = dict(launches)
    for t_max in (FLT_MAX, tm):
        k = trace(o, d, t_max, tabs, T_MIN)
        p = trace_ref(o, d, t_max, tabs, T_MIN)
        for a, b in zip(k, p):  # t, tri, per-ray counters
            assert torch.equal(a, b)
        assert (k[1] >= 0).float().mean() > 0.1
        ok, ck = occluded(o, d, t_max, tabs, T_MIN)
        op, cp = occluded_ref(o, d, t_max, tabs, T_MIN)
        assert torch.equal(ok, op) and torch.equal(ck, cp)
        assert torch.equal(ok, k[1] >= 0)
    assert not ok[::7].any() and not ck[:, ::7].any()
    assert launches["nearest"] == before["nearest"] + 2
    assert launches["any_hit"] == before["any_hit"] + 2


@pytest.mark.gpu
def test_heap_kernel_bit_equal(dev):
    mesh, o, d, tm = _bvh_inputs(dev)
    tabs = cb.heap_tables(mesh)
    _assert_walks_equal(cb.heap_trace, cb.heap_occluded, cb._heap_trace_ref,
                        cb._heap_occluded_ref, cb.LAUNCHES, o, d, tm, tabs)


@pytest.mark.gpu
@pytest.mark.parametrize("width,quant", [(32, False), (64, True)])
def test_bvh4_kernel_bit_equal(dev, width, quant):
    mesh, o, d, tm = _bvh_inputs(dev, seed=1)
    tabs = cb4.bvh4_tables(tb4.attach_bvh4(mesh, width=width,
                                           quant=quant).bvh4)
    _assert_walks_equal(cb4.bvh4_trace, cb4.bvh4_occluded,
                        cb4._bvh4_trace_ref, cb4._bvh4_occluded_ref,
                        cb4.LAUNCHES, o, d, tm, tabs)


@pytest.mark.gpu
def test_bvh4_stack_overflow_raises_or_stops(dev):
    """Tables beyond the kernel's stack capacity are refused; a stack_cap
    that understates the tree stops the ray (leaf_pop = -1) without
    writing past the stack and sets the flag check_stack raises for, and
    the plain walk raises."""
    mesh, o, d, _ = _bvh_inputs(dev, n=2000, seed=2)
    tabs = cb4.bvh4_tables(tb4.build_bvh4(mesh, width=32))
    with pytest.raises(ValueError, match="stack"):
        cb4.bvh4_trace(o, d, FLT_MAX,
                       tabs._replace(stack_cap=cb4.STACK_CAPACITY + 1),
                       T_MIN)
    small = tabs._replace(stack_cap=1,
                          overflow=torch.zeros_like(tabs.overflow))
    _, _, cnt = cb4.bvh4_trace(o, d, FLT_MAX, small, T_MIN)
    torch.cuda.synchronize()
    assert (cnt[3] == -1).any()
    with pytest.raises(RuntimeError, match="overflow"):
        cb4.check_stack(small)
    with pytest.raises(RuntimeError, match="overflow"):
        cb4._bvh4_trace_ref(o, d, FLT_MAX, small, T_MIN)
    t, tri, _ = cb4.bvh4_trace(o, d, FLT_MAX, tabs, T_MIN)  # still sound
    assert torch.equal(tri, cb4._bvh4_trace_ref(o, d, FLT_MAX, tabs,
                                                T_MIN)[1])
    cb4.check_stack(tabs)


@pytest.mark.gpu
def test_bvh4_render_stack_overflow_raises(dev):
    """A render through the BVH4 kernels over tables whose stack_cap
    understates the tree raises after its loop."""
    cfg = RenderConfig(nx=48, ny=32, ns=1, max_depth=4, textures=False,
                       packet_threshold=1)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, nu=96, nv=24,
                                prims_per_leaf=32, device=dev)
    mesh = tb4.attach_bvh4(scene.mesh, width=32)
    mesh = dataclasses.replace(
        mesh, bvh4=dataclasses.replace(mesh.bvh4, stack_cap=0))
    scene = dataclasses.replace(scene, mesh=mesh)
    cb4.LAUNCHES["nearest"] = 0
    with pytest.raises(RuntimeError, match="overflow"):
        render_image_regen(scene, cam, cfg)
    assert cb4.LAUNCHES["nearest"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("bvh4", [True, False])
def test_small_packet_render_kernel_equals_plain(dev, bvh4):
    cfg = RenderConfig(nx=48, ny=32, ns=2, max_depth=8, textures=False,
                       packet_threshold=1, bvh4=bvh4)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, nu=96, nv=24,
                                prims_per_leaf=32, device=dev)
    scene = dataclasses.replace(
        scene, mesh=tb4.attach_bvh4(scene.mesh, width=32))
    mod = cb4 if bvh4 else cb
    for key in mod.LAUNCHES:
        mod.LAUNCHES[key] = 0
    img = render_image_regen(scene, cam, cfg)
    assert mod.LAUNCHES["nearest"] > 0 and mod.LAUNCHES["any_hit"] > 0
    names = (("bvh4_trace", "bvh4_occluded") if bvh4
             else ("heap_trace", "heap_occluded"))
    with mock.patch.object(mod, names[0], getattr(mod, f"_{names[0]}_ref")), \
            mock.patch.object(mod, names[1],
                              getattr(mod, f"_{names[1]}_ref")):
        ref = render_image_regen(scene, cam, cfg)
    np.testing.assert_array_equal(img, ref)


# fast_math: the kernel's reciprocal is within ~1 ulp of the plain
# version's division, so t moves by a few ulps
FAST_T_RTOL = 2.0 ** -20


@pytest.mark.gpu
def test_heap_fast_math_within_bound(dev):
    """The heap kernels' fast_math mode against the plain (exact) walk: t
    within 2^-20 relative where the winners agree, winners and occlusion
    equal on all but a handful of lanes (near an accept bound)."""
    mesh, o, d, tm = _bvh_inputs(dev, seed=3)
    tabs = cb.heap_tables(mesh)
    before = dict(cb.LAUNCHES)
    for t_max in (FLT_MAX, tm):
        tk, ik, _ = cb.heap_trace(o, d, t_max, tabs, T_MIN,
                                  approx_recip=True)
        tp, ip, _ = cb._heap_trace_ref(o, d, t_max, tabs, T_MIN)
        same = (ik == ip) & (ip >= 0)
        assert int((ik != ip).sum()) <= 8
        assert bool(((tk - tp).abs() <= FAST_T_RTOL * tp.abs())[same].all())
        ok, _ = cb.heap_occluded(o, d, t_max, tabs, T_MIN, approx_recip=True)
        op, _ = cb._heap_occluded_ref(o, d, t_max, tabs, T_MIN)
        assert int((ok != op).sum()) <= 8
    assert cb.LAUNCHES["nearest_fast_math"] == \
        before["nearest_fast_math"] + 2
    assert cb.LAUNCHES["any_hit_fast_math"] == \
        before["any_hit_fast_math"] + 2
    assert cb.LAUNCHES["nearest"] == before["nearest"]


@pytest.mark.gpu
@pytest.mark.parametrize("passes", [3, 6])
def test_mx_kernel_bit_equal(dev, passes):
    mesh, o, d, tm = _bvh_inputs(dev, seed=4)
    tabs = cmx.mx_tables(mesh)
    before = dict(cmx.LAUNCHES)
    for t_max in (FLT_MAX, tm):
        k = cmx.mx_trace(o, d, t_max, tabs, T_MIN, passes)
        p = cmx._mx_trace_ref(o, d, t_max, tabs, T_MIN, passes)
        for a, b in zip(k, p):  # the kernel's t, tri, per-ray counters
            assert torch.equal(a, b)
        assert (k[1] >= 0).float().mean() > 0.1
        ok, ck = cmx.mx_occluded(o, d, t_max, tabs, T_MIN, passes)
        op, cp = cmx._mx_occluded_ref(o, d, t_max, tabs, T_MIN, passes)
        assert torch.equal(ok, op) and torch.equal(ck, cp)
    assert not ok[::7].any() and not ck[:, ::7].any()
    assert cmx.LAUNCHES["nearest"] == before["nearest"] + 2
    assert cmx.LAUNCHES["any_hit"] == before["any_hit"] + 2


@pytest.mark.gpu
@pytest.mark.parametrize("ppl", [16, 64])
def test_mr_kernel_bit_equal(dev, ppl):
    """K12a and K12b against their plain packet walks: t, winners,
    occlusion and the per-packet counters bit-equal; t and occlusion also
    equal to the heap walk's (K5, K6). n is no multiple of 32, so the last
    packet has padding lanes."""
    mesh, o, d, tm = _bvh_inputs(dev, n=40_003, seed=6, ppl=ppl)
    tabs = cb.heap_tables(mesh)
    before = dict(cmr.LAUNCHES)
    for t_max in (FLT_MAX, tm):
        (k, ck) = cmr.mr_trace(o, d, t_max, tabs, T_MIN)
        (p, cp) = cmr._mr_trace_ref(o, d, t_max, tabs, T_MIN)
        torch.cuda.synchronize()
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        assert torch.equal(ck, cp) and ck.shape == (3, (40_003 + 31) // 32)
        assert torch.equal(k[0], cb._heap_trace_ref(o, d, t_max, tabs,
                                                    T_MIN)[0])
        assert (k[1] >= 0).float().mean() > 0.1
        ok, cko = cmr.mr_occluded(o, d, t_max, tabs, T_MIN)
        op, cpo = cmr._mr_occluded_ref(o, d, t_max, tabs, T_MIN)
        assert torch.equal(ok, op) and torch.equal(cko, cpo)
        assert torch.equal(ok, cb._heap_occluded_ref(o, d, t_max, tabs,
                                                     T_MIN)[0])
    assert not ok[::7].any() and (k[1][::7] == -1).all()
    assert cmr.LAUNCHES["nearest"] == before["nearest"] + 2
    assert cmr.LAUNCHES["any_hit"] == before["any_hit"] + 2


@pytest.mark.gpu
def test_rg_kernel_bit_equal(dev):
    """The regrouped kernel against its plain rounds: t, winners and
    per-ray counters bit-equal; t also equal to the heap walk's."""
    mesh, o, d, tm = _bvh_inputs(dev, seed=5)
    tabs = cb.heap_tables(mesh)
    before = crg.LAUNCHES["nearest"]
    for t_max in (FLT_MAX, tm):
        k = crg.rg_trace(o, d, t_max, tabs, T_MIN)
        p = crg._rg_trace_ref(o, d, t_max, tabs, T_MIN)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        h = cb._heap_trace_ref(o, d, t_max, tabs, T_MIN)
        assert torch.equal(k[0], h[0])
        assert int(k[2][2].sum()) >= int(h[2][2].sum())
    assert not k[2][:, ::7].any() and (k[1][::7] == -1).all()
    assert crg.LAUNCHES["nearest"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("knob", ["mx_leaf", "regroup", "fast_math"])
def test_small_knob_render_kernel_vs_plain(dev, knob):
    """A small knot through each heap variant's kernels: bit-equal to its
    plain versions (mx_leaf, regroup), or within the fast_math bound of
    the exact render."""
    cfg = RenderConfig(nx=48, ny=32, ns=2, max_depth=8, textures=False,
                       packet_threshold=1, bvh4=False)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, nu=96, nv=24,
                                prims_per_leaf=32, device=dev)
    kcfg = cfg.replace(**{knob: True})
    mods = (cb, cmx, crg)
    for mod in mods:
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0
    img = render_image_regen(scene, cam, kcfg)
    if knob == "mx_leaf":
        assert min(cmx.LAUNCHES.values()) > 0
        assert sum(cb.LAUNCHES.values()) == 0
        plain = [(cmx, "mx_trace", cmx._mx_trace_ref),
                 (cmx, "mx_occluded", cmx._mx_occluded_ref)]
    elif knob == "regroup":
        assert crg.LAUNCHES["nearest"] > 0 and cb.LAUNCHES["any_hit"] > 0
        assert cb.LAUNCHES["nearest"] == 0
        plain = [(crg, "rg_trace", crg._rg_trace_ref),
                 (cb, "heap_occluded", cb._heap_occluded_ref)]
    else:
        assert cb.LAUNCHES["nearest_fast_math"] > 0
        assert cb.LAUNCHES["any_hit_fast_math"] > 0
        assert cb.LAUNCHES["nearest"] == cb.LAUNCHES["any_hit"] == 0
        plain = [(cb, "heap_trace", cb._heap_trace_ref),
                 (cb, "heap_occluded", cb._heap_occluded_ref)]
    with mock.patch.object(*plain[0]), mock.patch.object(*plain[1]):
        ref = render_image_regen(scene, cam, kcfg)
    if knob == "fast_math":
        # the plain versions keep the exact division
        assert np.sqrt(np.mean((img - ref) ** 2)) < 1e-3
    else:
        np.testing.assert_array_equal(img, ref)


@pytest.mark.gpu
def test_iter_ablate_kernel_bit_equal(dev):
    """K13's three modes against their plain walks: acc and per-ray
    counters bit-equal; every mode visits the same nodes and leaves."""
    mesh, o, d, tm = _bvh_inputs(dev, seed=7, ppl=64)
    tabs = cb.heap_tables(mesh)
    before = dict(ia.LAUNCHES)
    for t_max in (torch.full_like(tm, FLT_MAX), tm):
        cnts = []
        for mode in ia.MODES:
            acc, cnt = ia.ablate_trace(o, d, t_max, tabs, T_MIN, mode)
            p_acc, p_cnt = ia._ablate_ref(o, d, t_max, tabs, T_MIN, mode)
            torch.cuda.synchronize()
            assert torch.equal(acc, p_acc) and torch.equal(cnt, p_cnt)
            assert (acc != 0).any() == (mode != "noleaf")
            cnts.append(cnt)
        assert all(torch.equal(c, cnts[0]) for c in cnts)
    assert not cnt[:, ::7].any()
    assert all(ia.LAUNCHES[m] == before[m] + 2 for m in ia.MODES)


@pytest.mark.gpu
def test_dual_probe_kernel_bit_equal(dev):
    """K16 at R = 1, 2 and 4 against the plain node phase, bit for bit;
    n is no multiple of 128 R, so the last threads hold fewer rays."""
    mesh, o, d, _ = _bvh_inputs(dev, n=40_003, seed=8, ppl=64)
    tabs = cb.heap_tables(mesh)
    want = dp._dual_steps_ref(o, d, tabs)
    before = dict(dp.LAUNCHES)
    for r in dp.RAYS_PER_THREAD:
        assert torch.equal(dp.dual_steps(o, d, tabs, r), want)
    assert int(want.min()) >= 1 and int(want.max()) > 10
    assert all(dp.LAUNCHES[k] == before[k] + 1 for k in dp.LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", lm.MODES)
def test_leafmt_kernel_bit_equal(dev, mode):
    """K14 in each mode against its plain version on the probe's inputs,
    two tiles: closest and besti bit-equal, at 700 visits past the 611
    clusters' wrap too; cond with its branch never taken runs no visit."""
    args = lm.probe_inputs(2, dev)
    before = lm.LAUNCHES[mode]
    for visits in (1, 7, 64, 700):
        k = lm.leafmt_run(*args, visits, mode)
        p = lm._leafmt_ref(*args, visits, mode)
        torch.cuda.synchronize()
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert (k[1] >= 0).any() and torch.equal(k[0][:lm.TILE], k[0][lm.TILE:])
    assert lm.LAUNCHES[mode] == before + 4
    if mode == "cond":
        closest, best = lm.leafmt_run(*args, 7, mode, skip=1)
        assert (best == -1).all() and torch.equal(closest, args[2])


@pytest.mark.gpu
def test_dma_probe_kernel_bit_equal(dev):
    """K15a and K15b against the plain in-order sum, bit for bit, up to
    the probe's lower slope point."""
    blocks = dm.probe_blocks(device=dev)
    before = dict(dm.LAUNCHES)
    for k in (0, 1, 2, 1000, 4097, dm.COPIES[0]):
        want = dm._dma_chain_ref(blocks, k)
        for mode in dm.MODES:
            assert torch.equal(dm.dma_chain(blocks, k, mode), want)
    assert all(dm.LAUNCHES[m] == before[m] + 6 for m in dm.MODES)
