"""The CUDA sphere (exact and mx), triangle, heap-BVH (exact and
fast_math, on its contract cases and at the dragon's lane pool; MXU-leaf,
regrouped, packet walk) and BVH4 kernels, and the
probes' kernels (K13-K16), the TPU micro-benchmarks' (K17a-K20), the
regroup and 8-row packet probes' (K21-K24), the sphere layout probe's
(K25a, K25b) and the shape-cast probe's (K26),
against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

(``--noconftest``: the suite's conftest configures JAX.)
"""

import ctypes
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine import wavefront as wf
from tpu_pathtracer_torch.engine.regen import render_image_regen
from tpu_pathtracer_torch.experiments import common
from tpu_pathtracer_torch.experiments import dma_probe as dm
from tpu_pathtracer_torch.experiments import dual_probe as dp
from tpu_pathtracer_torch.experiments import gather_probe as gp
from tpu_pathtracer_torch.experiments import iter_ablate as ia
from tpu_pathtracer_torch.experiments import leafmt_probe as lm
from tpu_pathtracer_torch.experiments import leafround_probe as lr
from tpu_pathtracer_torch.experiments import multirow_probe as mr
from tpu_pathtracer_torch.experiments import regroup_probe as rp
from tpu_pathtracer_torch.experiments import shapecast_probe as sc
from tpu_pathtracer_torch.experiments import sphere_layout_probe as sl
from tpu_pathtracer_torch.experiments import tpu_micro as um
from tpu_pathtracer_torch.experiments import yardsticks
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import _build
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
import bvh4_cases
import bvh_mx_cases
import heap_cases
import leaf_cases
import leafmt_cases
import micro_cases
import mr_cases
import multirow_cases
import regroup_cases
import rg_cases
import sphere_cases
import tri_cases

T_MIN = 0.01


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _op_recorder():
    """A dispatch mode that records, by name (``.ops``), the aten ops
    dispatched under it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func.overloadpacket.__name__))
            return func(*args, **(kwargs or {}))
    return Ops()


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
def test_spheres_mx_within_bound(dev, per_ray_tmax):
    """K2 and K3 (``mx=True``) against their plain versions: the tensor
    cores sum the split products in their own order, so each lane's
    winner, t and occlusion is held by the bound (``mx_product_bound``
    carried through the roots): winners agree but where the bound can
    flip them, t within it, features equal where the winners agree. K3
    against K2 stays exact: occluded where K2 hits."""
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
    near = cs.mx_nearest_departures(o, d, c, r, T_MIN, tm, (tk, ik, fk),
                                    (tp, ip, fp))
    anyh = cs.mx_anyhit_departures(o, d, c, r, T_MIN, tm, ok, op)
    assert near["differ"] <= 1e-3 * near["lanes"]
    assert anyh["differ"] <= 1e-3 * anyh["lanes"]
    # K3 and K2 share the mma and the epilogue's test: the same lanes
    assert torch.equal(ok, ik >= 0)
    assert (ik >= 0).float().mean() > 0.1
    assert not torch.isin(ik, torch.arange(0, 700, 50, device=dev)).any()
    assert cs.MX_LAUNCHES["features"] == before[0]["features"] + 1
    assert cs.MX_LAUNCHES["any_hit"] == before[0]["any_hit"] + 1
    assert cs.LAUNCHES == before[1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", sphere_cases.CASES)
def test_spheres_mx_cases_within_bound(dev, name):
    """K2 and K3 on the sphere kernel's contract cases (ties, misses,
    radius <= 0, dead and NaN t_max, S across the 32-sphere chunks and
    the 1024-sphere tiles, N off the 8-ray tiles), by the bound; K3
    occluded exactly where K2 hits."""
    o, d, c, r, t_max, _ = sphere_cases.case(name)
    to = lambda v: V3(*(x.to(dev) for x in sphere_cases.tv3(v)))
    o, d, c = to(o), to(d), to(c)
    r = torch.from_numpy(r).to(dev)
    feat = torch.arange(r.numel() * 3, dtype=torch.float32,
                        device=dev).view(-1, 3)
    tm = (FLT_MAX if t_max is None
          else torch.from_numpy(t_max).to(dev))
    k = cs.spheres_hit_feat(o, d, c, r, feat, T_MIN, tm, mx=True)
    p = cs._spheres_hit_feat_ref(o, d, c, r, feat, T_MIN, tm, mx=True)
    cs.mx_nearest_departures(o, d, c, r, T_MIN, tm, k, p)
    ok = cs.spheres_anyhit_soa(o, d, c, r, T_MIN, tm, mx=True)
    op = cs._spheres_anyhit_ref(o, d, c, r, T_MIN, tm, mx=True)
    cs.mx_anyhit_departures(o, d, c, r, T_MIN, tm, ok, op)
    assert torch.equal(ok, k[1] >= 0)


@pytest.mark.gpu
def test_spheres_mx_products_within_bound(dev):
    """The kernel's products mode: c·d and o·c from the tensor cores,
    each within ``mx_product_bound`` of the plain version's fixed order,
    over 1024 spheres and more (two tiles)."""
    o, d, c, r, _ = _inputs(dev, n=4096, s=1100, seed=3)
    before = cs.MX_PRODUCT_LAUNCHES
    cd, oc = cs.spheres_mx_products(o, d, c, r)
    torch.cuda.synchronize()
    assert cs.MX_PRODUCT_LAUNCHES == before + 1
    tab = cs.mx_sphere_table(c, r)
    for got, want, bound in zip((cd, oc), cs.mx_products(o, d, tab),
                                cs.mx_product_bound(o, d, tab)):
        assert got.shape == (4096, 1100)
        assert ((got.double() - want.double()).abs() <= bound).all()


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
    # the plain version builds its own table: the engine's is dropped
    with mock.patch.object(cs, "spheres_hit_feat",
                           lambda *a, tab=None: cs._spheres_hit_feat_ref(*a)):
        ref = render_image_regen(scene, cam, cfg)
    np.testing.assert_array_equal(img, ref)


def _sphere_modes_bit_equal(o, d, c, r, feat, tm, tab=None):
    """All three modes of the kernel against the plain version, bit-equal
    in every output; returns the kernel's (t, idx, features)."""
    args = (o, d, c, r, T_MIN, tm)
    before = cs.LAUNCHES
    k = cs.spheres_hit_feat(*args[:4], feat, *args[4:], tab=tab)
    p = cs._spheres_hit_feat_ref(*args[:4], feat, *args[4:])
    torch.cuda.synchronize()
    assert cs.LAUNCHES == before + 1
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(torch.stack(k[2]), torch.stack(p[2]))
    for a, b in zip(cs.spheres_hit_soa(*args, tab=tab), k[:2]):
        assert torch.equal(a, b)
    assert torch.equal(cs.spheres_hit_soa(*args, tab=tab)[0],
                       cs._spheres_hit_ref(*args)[0])
    occ = cs.spheres_anyhit_soa(*args, tab=tab)
    assert torch.equal(occ, cs._spheres_anyhit_ref(*args))
    return k


@pytest.mark.gpu
@pytest.mark.parametrize("with_tab", [False, True])
@pytest.mark.parametrize("name", sphere_cases.CASES)
def test_sphere_contract_cases_bit_equal(dev, name, with_tab):
    """The contract's edge cases (tests/sphere_cases.py, held against the
    JAX kernel on the CPU), the kernel against the plain version, with the
    table built by the wrapper or passed in, and t_max as an [N] tensor
    and, where the case has one t_max for every ray, as a float."""
    o, d, c, r, tm, check = sphere_cases.case(name)
    n = o.shape[0]
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       .to(dev) for k in range(3)))
    c, r = v(c), torch.from_numpy(r).to(dev)
    feat = torch.from_numpy(np.random.RandomState(13).uniform(
        -3, 3, (r.shape[0], 18)).astype(np.float32)).to(dev)
    tab = cs.sphere_table(c, r) if with_tab else None
    tms = [torch.from_numpy(np.full(n, FLT_MAX, np.float32) if tm is None
                            else tm).to(dev)]
    if tm is None:
        tms.append(FLT_MAX)
    for t_max in tms:
        k = _sphere_modes_bit_equal(v(o), v(d), c, r, feat, t_max, tab)
        check((k[0].cpu().numpy(), k[1].cpu().numpy(),
               torch.stack(k[2], 1).cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("t_max", [FLT_MAX, 8.0, T_MIN, -1.0, float("nan")])
def test_sphere_float_tmax_bit_equal(dev, t_max):
    """One t_max for every ray, passed to the kernel as a float: live,
    finite, dead (<= t_min) and NaN."""
    o, d, c, r, feat = _inputs(dev, n=4099, s=486, seed=6)
    k = _sphere_modes_bit_equal(o, d, c, r, feat, t_max,
                                cs.sphere_table(c, r))
    live = t_max > T_MIN  # False for NaN
    assert bool((k[1] >= 0).any()) == live


@pytest.mark.gpu
@pytest.mark.parametrize("n", [32_768, 960_000])
def test_spheres_pool_and_frame_shapes_bit_equal(dev, n):
    """The lane pool the regen engine launches K1 on, and a whole
    1200x800 frame of rays, against the headline's 486 spheres."""
    o, d, c, r, feat = _inputs(dev, n=n, s=486, seed=7)
    tab = cs.sphere_table(c, r)
    k = _sphere_modes_bit_equal(o, d, c, r, feat, FLT_MAX, tab)
    assert (k[1] >= 0).float().mean() > 0.1
    tm = torch.linspace(0.5, 30.0, n, device=dev)
    _sphere_modes_bit_equal(o, d, c, r, feat, tm, tab)


@pytest.mark.gpu
def test_sphere_frame_call_dispatches_only_its_outputs(dev):
    """The frame's call, spheres_hit_feat with the view's table and a
    float t_max, dispatches its three output allocations and the unbind
    of the features, and nothing else: no table build, no [N] t_max."""
    cfg = RenderConfig(nx=48, ny=32, ns=1, max_depth=2)
    scene, cam = random_spheres_scene(cfg.nx, cfg.ny, device=dev)
    view = wf.make_view(scene, cfg)
    o, d = cam.generate_rays(torch.arange(cfg.num_pixels, device=dev), 0,
                             cfg.nx, cfg.ny)
    call = lambda: cs.spheres_hit_feat(o, d, view.sph_c, view.sph_r,
                                       view.sph_feat, cfg.epsilon, FLT_MAX,
                                       tab=view.sph_tab)
    call()  # built and loaded
    before = cs.LAUNCHES
    with _op_recorder() as mode:
        call()
    assert cs.LAUNCHES == before + 1
    assert sorted(mode.ops) == ["empty", "empty", "empty", "unbind"]


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
    # the plain versions build their own table: the engine's is dropped
    with mock.patch.object(ct, "tris_hit_feat",
                           lambda *a, tab=None: ct._tris_hit_feat_ref(*a)), \
            mock.patch.object(ct, "tris_anyhit_soa",
                              lambda *a, tab=None: ct._tris_anyhit_ref(*a)):
        ref = render_image_regen(scene, cam, cfg)
    np.testing.assert_array_equal(img, ref)


def _tri_modes_bit_equal(o, d, tri, feat, tm, tab=None):
    """All three modes of the kernel against the plain version, bit-equal
    in every output; returns the kernel's (t, idx, u, v, features)."""
    args = (o, d, *tri, T_MIN, tm)
    k = ct.tris_hit_feat(*args[:6], feat, *args[6:], tab=tab)
    p = ct._tris_hit_feat_ref(*args[:6], feat, *args[6:])
    torch.cuda.synchronize()
    for a, b in zip(k[:4], p[:4]):
        assert torch.equal(a, b)
    assert torch.equal(torch.stack(k[4]), torch.stack(p[4]))
    for a, b in zip(ct.tris_hit_soa(*args, tab=tab), k[:4]):
        assert torch.equal(a, b)
    occ = ct.tris_anyhit_soa(*args, tab=tab)
    assert torch.equal(occ, ct._tris_anyhit_ref(*args))
    return k


@pytest.mark.gpu
@pytest.mark.parametrize("name", tri_cases.CASES)
def test_tris_contract_cases_bit_equal(dev, name):
    """The contract's edge cases (tests/tri_cases.py, held against the
    JAX kernel on the CPU), the kernel against the plain version."""
    o, d, tri, tm, check = tri_cases.case(name)
    tri = tri_cases.prep(tri[:, 0], tri[:, 1], tri[:, 2])
    n = o.shape[0]
    tm = np.full(n, FLT_MAX, np.float32) if tm is None else tm
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       .to(dev) for k in range(3)))
    feat = torch.from_numpy(np.random.RandomState(14).uniform(
        -3, 3, (tri[0].shape[0], 26)).astype(np.float32)).to(dev)
    k = _tri_modes_bit_equal(v(o), v(d), [v(a) for a in tri], feat,
                             torch.from_numpy(tm).to(dev))
    check(tuple(a.cpu().numpy() for a in k[:4]))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [32_768, 960_000])
def test_tris_pool_and_frame_shapes_bit_equal(dev, n):
    """The lane pool the regen engine launches on, and a whole 1200x800
    frame of rays, against the staircase's 384-slot table size."""
    o, d, v0, e1, e2, nrm, feat, tm = _tri_inputs(dev, n=n, t=384, seed=2)
    tab = ct.tri_table(v0, e1, e2, nrm)
    k = _tri_modes_bit_equal(o, d, (v0, e1, e2, nrm), feat, tm, tab)
    assert (k[1] >= 0).float().mean() > 0.1
    assert (k[1][::7] == -1).all()


@pytest.mark.gpu
@pytest.mark.parametrize("live", [0.0, 0.4, 1.0])
def test_tris_anyhit_live_shares_bit_equal(dev, live):
    """Any-hit at 32,768 lanes with no, ~40% and every lane carrying a
    shadow ray, t_max before or past the nearest hit."""
    o, d, v0, e1, e2, nrm, _, _ = _tri_inputs(dev, n=32_768, t=384, seed=3)
    tri = (v0, e1, e2, nrm)
    t, idx = ct.tris_hit_soa(o, d, *tri, T_MIN, FLT_MAX)[:2]
    gen = torch.Generator(device=dev).manual_seed(4)
    r = torch.rand(t.shape, generator=gen, device=dev)
    odd = torch.arange(t.numel(), device=dev) % 2 == 1
    tm = torch.where(idx >= 0, t * torch.where(odd, 0.5, 1.001), 30.0)
    tm = torch.where(r < live, tm, -1.0)
    args = (o, d, *tri, T_MIN, tm)
    occ = ct.tris_anyhit_soa(*args)
    assert torch.equal(occ, ct._tris_anyhit_ref(*args))
    assert not occ[tm <= T_MIN].any()
    if live:
        assert occ.any() and not occ[tm > T_MIN].all()


@pytest.mark.gpu
def test_tris_largest_brute_table_bit_equal(dev):
    """T = 16,384, the largest mesh the engine sends to this kernel
    (wavefront.TRI_BRUTE_MAX): 32 tiles of the kernel."""
    o, d, v0, e1, e2, nrm, feat, tm = _tri_inputs(dev, n=8192, t=16_384,
                                                  seed=5)
    k = _tri_modes_bit_equal(o, d, (v0, e1, e2, nrm), feat, tm)
    assert (k[1] >= 15_872).any()  # winners in the last tile


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
@pytest.mark.parametrize("width,quant", [(32, False), (64, True),
                                         (64, False), (33, False)])
def test_bvh4_kernel_bit_equal(dev, width, quant):
    mesh, o, d, tm = _bvh_inputs(dev, seed=1)
    tabs = cb4.bvh4_tables(tb4.attach_bvh4(mesh, width=width,
                                           quant=quant).bvh4)
    _assert_walks_equal(cb4.bvh4_trace, cb4.bvh4_occluded,
                        cb4._bvh4_trace_ref, cb4._bvh4_occluded_ref,
                        cb4.LAUNCHES, o, d, tm, tabs)


def _bvh4_modes_bit_equal(o, d, tm, tabs):
    """Both modes of the kernel against the plain walk, bit-equal in
    every output (a NaN t_max gives t = NaN on both sides); returns the
    kernel's (t, tri, occ, counters) as numpy arrays."""
    t, tri, cnt = cb4.bvh4_trace(o, d, tm, tabs, T_MIN)
    occ, ocnt = cb4.bvh4_occluded(o, d, tm, tabs, T_MIN)
    pt, ptri, pcnt = cb4._bvh4_trace_ref(o, d, tm, tabs, T_MIN)
    pocc, pocnt = cb4._bvh4_occluded_ref(o, d, tm, tabs, T_MIN)
    torch.cuda.synchronize()
    cb4.check_stack(tabs)
    np.testing.assert_array_equal(t.cpu().numpy(), pt.cpu().numpy())
    for a, b in ((tri, ptri), (cnt, pcnt), (occ, pocc), (ocnt, pocnt)):
        assert torch.equal(a, b)
    return tuple(a.cpu().numpy() for a in (t, tri, occ, cnt))


@pytest.mark.gpu
@pytest.mark.parametrize("name", bvh4_cases.CASES)
def test_bvh4_contract_cases_bit_equal(dev, name):
    """The contract's edge cases (tests/bvh4_cases.py, held against the
    JAX kernels on the CPU), the kernel against the plain walk in both
    modes, and each case's own check. Where the case knows its deepest
    stack, the kernel runs at exactly that stack_cap without overflow
    and stops a ray at one less."""
    c = bvh4_cases.case(name)
    if c.tree is not None:
        t4 = tb4._assemble4(*bvh4_cases.assemble_args(c.tree), dev)
    else:
        base, v1, v2, _, _ = bvh4_cases.soup(c.soup["t"], c.soup["seed"])
        mesh = tbvh.build_bvh(base, v1, v2, prims_per_leaf=16, bvh4=False,
                              device=dev)
        t4 = tb4.attach_bvh4(mesh, width=c.soup["width"],
                             quant=c.soup["quant"]).bvh4
    tabs = cb4.bvh4_tables(t4)
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       .to(dev) for k in range(3)))
    o, d, tm = v(c.o), v(c.d), torch.from_numpy(c.t_max).to(dev)
    c.check(*_bvh4_modes_bit_equal(o, d, tm, tabs))
    if c.need is not None:
        _bvh4_modes_bit_equal(o, d, tm, tabs._replace(stack_cap=c.need))
        short = tabs._replace(stack_cap=c.need - 1,
                              overflow=torch.zeros_like(tabs.overflow))
        _, _, cnt = cb4.bvh4_trace(o, d, tm, short, T_MIN)
        torch.cuda.synchronize()
        assert (cnt[3] == -1).all()
        with pytest.raises(RuntimeError, match="overflow"):
            cb4.check_stack(short)


@pytest.mark.gpu
def test_bvh4_divergent_warps_bit_equal(dev):
    """Rays from one origin inside the soup, neighbouring lanes into
    opposite halves of it: every warp's rays walk different nodes and
    leaves."""
    mesh, _, _, _ = _bvh_inputs(dev, n=2, seed=3)
    tabs = cb4.bvh4_tables(tb4.attach_bvh4(mesh, width=64).bvh4)
    rng = np.random.RandomState(4)
    n = 40_000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 0] = np.abs(d[:, 0]) * np.where(np.arange(n) % 2, -1, 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       .to(dev) for k in range(3)))
    o = v(np.zeros((n, 3), np.float32))
    tm = torch.where(torch.arange(n, device=dev) % 3 == 0, 4.0, FLT_MAX)
    t, tri, occ, cnt = _bvh4_modes_bit_equal(o, v(d), tm, tabs)
    assert (tri[0::2] >= 0).mean() > 0.5 and (tri[1::2] >= 0).mean() > 0.5
    assert occ.any() and not occ.all()


@pytest.mark.gpu
def test_bvh4_launches_count_one_a_call(dev):
    """Each wrapper call adds one to its mode's launch count."""
    mesh, o, d, tm = _bvh_inputs(dev, n=1000, seed=5)
    tabs = cb4.bvh4_tables(tb4.attach_bvh4(mesh, width=64).bvh4)
    before = dict(cb4.LAUNCHES)
    cb4.bvh4_trace(o, d, tm, tabs, T_MIN)
    assert cb4.LAUNCHES == {**before, "nearest": before["nearest"] + 1}
    cb4.bvh4_occluded(o, d, tm, tabs, T_MIN)
    cb4.bvh4_occluded(o, d, FLT_MAX, tabs, T_MIN)
    assert cb4.LAUNCHES == {"nearest": before["nearest"] + 1,
                            "any_hit": before["any_hit"] + 2}


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
@pytest.mark.parametrize("ppl", [5, 33, 64])
def test_heap_kernel_leaf_widths_bit_equal(dev, ppl):
    """Leaf widths that are no multiple of a pair's lanes (5, 33) and the
    dragon's 64."""
    mesh, o, d, tm = _bvh_inputs(dev, seed=9, ppl=ppl)
    tabs = cb.heap_tables(mesh)
    _assert_walks_equal(cb.heap_trace, cb.heap_occluded, cb._heap_trace_ref,
                        cb._heap_occluded_ref, cb.LAUNCHES, o, d, tm, tabs)


def _heap_modes_bit_equal(o, d, tm, tabs, t_min=T_MIN):
    """Both modes of K5/K6 against the plain walk, bit-equal in every
    output (a NaN t_max gives t = NaN on both sides), one launch a mode;
    returns the kernel's (t, tri, occ, counters) as numpy arrays."""
    before = dict(cb.LAUNCHES)
    t, tri, cnt = cb.heap_trace(o, d, tm, tabs, t_min)
    occ, ocnt = cb.heap_occluded(o, d, tm, tabs, t_min)
    assert cb.LAUNCHES == {**before, "nearest": before["nearest"] + 1,
                           "any_hit": before["any_hit"] + 1}
    pt, ptri, pcnt = cb._heap_trace_ref(o, d, tm, tabs, t_min)
    pocc, pocnt = cb._heap_occluded_ref(o, d, tm, tabs, t_min)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(t.cpu().numpy(), pt.cpu().numpy())
    for a, b in ((tri, ptri), (cnt, pcnt), (occ, pocc), (ocnt, pocnt)):
        assert torch.equal(a, b)
    return tuple(a.cpu().numpy() for a in (t, tri, occ, cnt))


def _heap_case(dev, name):
    """A contract case's tables and rays on the card."""
    c = heap_cases.case(name)
    tabs = cb.heap_tables(heap_cases.port_mesh(c, dev))
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       .to(dev) for k in range(3)))
    return c, tabs, v(c.o), v(c.d), torch.from_numpy(c.t_max).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", heap_cases.CASES)
def test_heap_contract_cases_bit_equal(dev, name):
    """The contract's edge cases (tests/heap_cases.py, held against the
    JAX kernels on the CPU), K5 and K6 against the plain walk, and each
    case's own check."""
    c, tabs, o, d, tm = _heap_case(dev, name)
    c.check(*_heap_modes_bit_equal(o, d, tm, tabs, heap_cases.T_MIN))


@pytest.mark.gpu
@pytest.mark.parametrize("name", heap_cases.CASES)
def test_heap_fast_math_contract_cases_within_bound(dev, name):
    """The fast_math mode on the contract's edge cases, held as
    test_heap_fast_math_within_bound holds it: t within 2^-20 relative
    where the winners agree, winners and occlusion equal on all but a
    handful of lanes."""
    c, tabs, o, d, tm = _heap_case(dev, name)
    t_min = heap_cases.T_MIN
    tk, ik, _ = cb.heap_trace(o, d, tm, tabs, t_min, approx_recip=True)
    tp, ip, _ = cb._heap_trace_ref(o, d, tm, tabs, t_min)
    same = (ik == ip) & (ip >= 0)
    assert int((ik != ip).sum()) <= 8
    assert bool(((tk - tp).abs() <= FAST_T_RTOL * tp.abs())[same].all())
    ok, _ = cb.heap_occluded(o, d, tm, tabs, t_min, approx_recip=True)
    op, _ = cb._heap_occluded_ref(o, d, tm, tabs, t_min)
    assert int((ok != op).sum()) <= 8


@pytest.mark.gpu
def test_heap_pool_bit_equal(dev):
    """The dragon frame's lane pool, 196,608 lanes (engine/regen.py, the
    untextured packet path), over 64-slot leaves; every 7th lane dead."""
    mesh, o, d, tm = _bvh_inputs(dev, n=196_608, seed=8, ppl=64)
    tabs = cb.heap_tables(mesh)
    t, tri, occ, cnt = _heap_modes_bit_equal(o, d, tm, tabs)
    assert (tri >= 0).mean() > 0.1 and not occ[::7].any()
    assert not cnt[:, ::7].any()


@pytest.mark.gpu
def test_heap_divergent_warps_bit_equal(dev):
    """Rays from one origin inside the soup, neighbouring lanes into
    opposite halves of it: every warp's rays walk different nodes and
    leaves."""
    mesh, _, _, _ = _bvh_inputs(dev, n=2, seed=3, ppl=64)
    tabs = cb.heap_tables(mesh)
    rng = np.random.RandomState(4)
    n = 40_000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 0] = np.abs(d[:, 0]) * np.where(np.arange(n) % 2, -1, 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       .to(dev) for k in range(3)))
    o = v(np.zeros((n, 3), np.float32))
    tm = torch.where(torch.arange(n, device=dev) % 3 == 0, 4.0, FLT_MAX)
    t, tri, occ, cnt = _heap_modes_bit_equal(o, v(d), tm, tabs)
    assert (tri[0::2] >= 0).mean() > 0.5 and (tri[1::2] >= 0).mean() > 0.5
    assert occ.any() and not occ.all()


@pytest.mark.gpu
def test_heap_frame_call_dispatches_only_its_outputs(dev):
    """The frame's calls, heap_trace and heap_occluded with the view's
    tables and an [N] t_max, in both arithmetic modes, dispatch their
    output allocations and the t_max view, and nothing else: no
    .tolist(), no _local_scalar_dense, no copy to the host."""
    cfg = RenderConfig(nx=48, ny=32, ns=1, max_depth=2, textures=False,
                       packet_threshold=1, bvh4=False)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, nu=96, nv=24,
                                prims_per_leaf=32, device=dev)
    view = wf.make_view(scene, cfg)
    assert isinstance(view.packet, cb.HeapTables)
    o, d = cam.generate_rays(torch.arange(cfg.num_pixels, device=dev), 0,
                             cfg.nx, cfg.ny)
    tm = torch.full((cfg.num_pixels,), FLT_MAX, device=dev)
    want = {"nearest": ["empty", "empty", "empty", "expand"],
            "any_hit": ["empty", "empty", "expand"]}
    for approx in (False, True):
        calls = {"nearest": lambda: cb.heap_trace(o, d, tm, view.packet,
                                                  cfg.epsilon,
                                                  approx_recip=approx),
                 "any_hit": lambda: cb.heap_occluded(o, d, tm, view.packet,
                                                     cfg.epsilon,
                                                     approx_recip=approx)}
        for mode, call in calls.items():
            key = mode + ("_fast_math" if approx else "")
            call()  # built and loaded
            before = cb.LAUNCHES[key]
            with _op_recorder() as ops:
                call()
            assert cb.LAUNCHES[key] == before + 1
            assert sorted(ops.ops) == want[mode]


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


def _mx_modes_bit_equal(o, d, tm, tabs, passes):
    """Both modes of K10 against the plain walk, bit-equal in every
    output (a NaN t_max gives t = NaN on both sides), one launch a mode;
    returns the kernel's (t, tri, occ, counters) as numpy arrays."""
    before = dict(cmx.LAUNCHES)
    t, tri, cnt = cmx.mx_trace(o, d, tm, tabs, T_MIN, passes)
    occ, ocnt = cmx.mx_occluded(o, d, tm, tabs, T_MIN, passes)
    assert cmx.LAUNCHES == {"nearest": before["nearest"] + 1,
                            "any_hit": before["any_hit"] + 1}
    pt, ptri, pcnt = cmx._mx_trace_ref(o, d, tm, tabs, T_MIN, passes)
    pocc, pocnt = cmx._mx_occluded_ref(o, d, tm, tabs, T_MIN, passes)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(t.cpu().numpy(), pt.cpu().numpy())
    for a, b in ((tri, ptri), (cnt, pcnt), (occ, pocc), (ocnt, pocnt)):
        assert torch.equal(a, b)
    return tuple(a.cpu().numpy() for a in (t, tri, occ, cnt))


@pytest.mark.gpu
@pytest.mark.parametrize("passes", [3, 6])
@pytest.mark.parametrize("name", bvh_mx_cases.CASES)
def test_mx_contract_cases_bit_equal(dev, name, passes):
    """The leaf test's edge cases (tests/bvh_mx_cases.py, held against
    the JAX kernels on the CPU), K10 and K10b against the plain walk, and
    each case's own check."""
    c = bvh_mx_cases.case(name)
    tabs = cmx.mx_tables(bvh_mx_cases.port_mesh(c, dev))
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       .to(dev) for k in range(3)))
    c.check(*_mx_modes_bit_equal(v(c.o), v(c.d),
                                 torch.from_numpy(c.t_max).to(dev), tabs,
                                 passes))


@pytest.mark.gpu
@pytest.mark.parametrize("passes", [3, 6])
def test_mx_pool_bit_equal(dev, passes):
    """The dragon frame's lane pool, 196,608 lanes (engine/regen.py, the
    untextured packet path), over 64-slot leaves; every 7th lane dead."""
    mesh, o, d, tm = _bvh_inputs(dev, n=196_608, seed=8, ppl=64)
    tabs = cmx.mx_tables(mesh)
    t, tri, occ, cnt = _mx_modes_bit_equal(o, d, tm, tabs, passes)
    assert (tri >= 0).mean() > 0.1 and not occ[::7].any()
    assert not cnt[:, ::7].any()


@pytest.mark.gpu
def test_mx_frame_call_dispatches_only_its_outputs(dev):
    """The frame's calls, mx_trace and mx_occluded with the view's tables
    and an [N] t_max, dispatch their output allocations and the t_max
    view, and nothing else: no .tolist(), no _local_scalar_dense, no copy
    to the host."""
    cfg = RenderConfig(nx=48, ny=32, ns=1, max_depth=2, textures=False,
                       packet_threshold=1, bvh4=False, mx_leaf=True)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, nu=96, nv=24,
                                prims_per_leaf=32, device=dev)
    view = wf.make_view(scene, cfg)
    assert isinstance(view.packet, cmx.MxTables)
    o, d = cam.generate_rays(torch.arange(cfg.num_pixels, device=dev), 0,
                             cfg.nx, cfg.ny)
    tm = torch.full((cfg.num_pixels,), FLT_MAX, device=dev)
    calls = {"nearest": lambda: cmx.mx_trace(o, d, tm, view.packet,
                                             cfg.epsilon, cfg.mx_passes),
             "any_hit": lambda: cmx.mx_occluded(o, d, tm, view.packet,
                                                cfg.epsilon, cfg.mx_passes)}
    want = {"nearest": ["empty", "empty", "empty", "expand"],
            "any_hit": ["empty", "empty", "expand"]}
    for mode, call in calls.items():
        call()  # built and loaded
        before = cmx.LAUNCHES[mode]
        with _op_recorder() as ops:
            call()
        assert cmx.LAUNCHES[mode] == before + 1
        assert sorted(ops.ops) == want[mode]


@pytest.mark.gpu
@pytest.mark.parametrize("ppl", [5, 8, 16, 64, 128])
def test_mr_kernel_bit_equal(dev, ppl):
    """K12a and K12b against their plain packet walks: t, winners,
    occlusion and the per-packet counters bit-equal; t and occlusion also
    equal to the heap walk's (K5, K6). n is no multiple of 32, so the last
    packet has padding lanes, and its 1,251 packets are no multiple of a
    block's packets at any kWarpsPerPacket below 8 (at 8, csrc/bvh_mr.cu's
    setting, a block is one packet). Leaf widths
    that are no multiple of a packet's warps (5) and wider than a stage of
    64 slots (128, staged in two chunks a leaf)."""
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
def test_mr_kernel_inert_and_dead_lanes(dev):
    """Lanes at t_max 0 (inert) and -1 (dead) among live ones: bit-equal
    to the plain walks, and such a lane has no winner, keeps its t_max
    and is not occluded."""
    mesh, o, d, tm = _bvh_inputs(dev, n=20_011, seed=9, ppl=64)
    lane = torch.arange(tm.shape[0], device=dev)
    tm = torch.where(lane % 5 == 0, 0.0, tm).contiguous()
    tabs = cb.heap_tables(mesh)
    (k, ck) = cmr.mr_trace(o, d, tm, tabs, T_MIN)
    (p, cp) = cmr._mr_trace_ref(o, d, tm, tabs, T_MIN)
    ok, cko = cmr.mr_occluded(o, d, tm, tabs, T_MIN)
    op, cpo = cmr._mr_occluded_ref(o, d, tm, tabs, T_MIN)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(ck, cp) and torch.equal(ok, op)
    assert torch.equal(cko, cpo)
    off = tm <= 0
    assert (k[1][off] == -1).all() and torch.equal(k[0][off], tm[off])
    assert not ok[off].any() and ok[~off].any()


@pytest.mark.gpu
@pytest.mark.parametrize("name", mr_cases.CASES)
def test_mr_merge_cases_bit_equal(dev, name):
    """tests/mr_cases.py on the card: K12a and K12b against their plain
    walks (t, winners, features, occlusion, per-packet counters
    bit-equal) and each case's own check: an equal t in a later-queued
    leaf loses though its heap slot is lower, of two equal-t slots in
    different warps the lower wins, the any-hit packet retires in its
    first leaf round, and a one-leaf tree is walked."""
    c = mr_cases.case(name)
    tabs = cb.heap_tables(mr_cases.port_mesh(c, dev))
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       .to(dev) for k in range(3)))
    o, d = v(c.o), v(c.d)
    tm = torch.from_numpy(c.t_max).to(dev)
    before = dict(cmr.LAUNCHES)
    (k, ck) = cmr.mr_trace(o, d, tm, tabs, T_MIN)
    (p, cp) = cmr._mr_trace_ref(o, d, tm, tabs, T_MIN)
    ok, cko = cmr.mr_occluded(o, d, tm, tabs, T_MIN)
    op, cpo = cmr._mr_occluded_ref(o, d, tm, tabs, T_MIN)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(ck, cp) and torch.equal(ok, op)
    assert torch.equal(cko, cpo)
    c.check(*(a.cpu().numpy() for a in (k[0], k[1], ok, ck, cko)))
    assert cmr.LAUNCHES["nearest"] == before["nearest"] + 1
    assert cmr.LAUNCHES["any_hit"] == before["any_hit"] + 1


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


def _rg_bit_equal(o, d, tm, tabs, t_min=T_MIN):
    """K11 against its plain walk, bit-equal in every output (a NaN t_max
    gives t = NaN on both sides), one launch; returns the kernel's (t,
    tri, counters) as numpy arrays."""
    before = crg.LAUNCHES["nearest"]
    t, tri, cnt = crg.rg_trace(o, d, tm, tabs, t_min)
    assert crg.LAUNCHES["nearest"] == before + 1
    pt, ptri, pcnt = crg._rg_trace_ref(o, d, tm, tabs, t_min)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(t.cpu().numpy(), pt.cpu().numpy())
    assert torch.equal(tri, ptri) and torch.equal(cnt, pcnt)
    return tuple(a.cpu().numpy() for a in (t, tri, cnt))


@pytest.mark.gpu
@pytest.mark.parametrize("name", rg_cases.CASES)
def test_rg_contract_cases_bit_equal(dev, name):
    """The regrouped walk's edge cases (tests/rg_cases.py, held against
    the JAX kernel and the heap walk on the CPU), K11 against its plain
    walk, and each case's own check."""
    c = rg_cases.case(name)
    tabs = cb.heap_tables(rg_cases.port_mesh(c, dev))
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       .to(dev) for k in range(3)))
    c.check(*_rg_bit_equal(v(c.o), v(c.d),
                           torch.from_numpy(c.t_max).to(dev), tabs,
                           rg_cases.T_MIN))


@pytest.mark.gpu
@pytest.mark.parametrize("ppl", [5, 33, 64])
def test_rg_kernel_leaf_widths_bit_equal(dev, ppl):
    """Leaf widths that are no multiple of a window's lanes (5, 33) and
    the dragon's 64; n no multiple of 32."""
    mesh, o, d, tm = _bvh_inputs(dev, n=40_003, seed=10, ppl=ppl)
    tabs = cb.heap_tables(mesh)
    for t_max in (FLT_MAX, tm):
        t, tri, cnt = _rg_bit_equal(o, d, t_max, tabs)
        assert (tri >= 0).mean() > 0.1
    assert not cnt[:, ::7].any() and (tri[::7] == -1).all()


@pytest.mark.gpu
def test_rg_pool_bit_equal(dev):
    """The dragon frame's lane pool, 196,608 lanes (engine/regen.py, the
    untextured packet path), over 64-slot leaves; every 7th lane dead;
    leaf visits within [1, 1.5]x the heap walk's."""
    mesh, o, d, tm = _bvh_inputs(dev, n=196_608, seed=8, ppl=64)
    tabs = cb.heap_tables(mesh)
    t, tri, cnt = _rg_bit_equal(o, d, tm, tabs)
    assert (tri >= 0).mean() > 0.1 and not cnt[:, ::7].any()
    te, _, ce = cb.heap_trace(o, d, tm, tabs, T_MIN)
    np.testing.assert_array_equal(t, te.cpu().numpy())
    visits, visits_heap = int(cnt[2].sum()), int(ce[2].sum())
    assert visits_heap <= visits <= 1.5 * visits_heap


@pytest.mark.gpu
def test_rg_divergent_warps_bit_equal(dev):
    """Rays from one origin inside the soup, neighbouring lanes into
    opposite halves of it: every warp's rays walk different nodes and
    leaves and fill their windows at different steps."""
    mesh, _, _, _ = _bvh_inputs(dev, n=2, seed=3, ppl=64)
    tabs = cb.heap_tables(mesh)
    rng = np.random.RandomState(4)
    n = 40_000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 0] = np.abs(d[:, 0]) * np.where(np.arange(n) % 2, -1, 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       .to(dev) for k in range(3)))
    o = v(np.zeros((n, 3), np.float32))
    tm = torch.where(torch.arange(n, device=dev) % 3 == 0, 4.0, FLT_MAX)
    t, tri, cnt = _rg_bit_equal(o, v(d), tm, tabs)
    assert (tri[0::2] >= 0).mean() > 0.5 and (tri[1::2] >= 0).mean() > 0.5


@pytest.mark.gpu
def test_rg_frame_call_dispatches_only_its_outputs(dev):
    """The frame's call, rg_trace with the view's tables and an [N]
    t_max, dispatches its output allocations and the t_max view, and
    nothing else: no .tolist(), no _local_scalar_dense, no copy to the
    host."""
    cfg = RenderConfig(nx=48, ny=32, ns=1, max_depth=2, textures=False,
                       packet_threshold=1, bvh4=False, regroup=True)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, nu=96, nv=24,
                                prims_per_leaf=32, device=dev)
    view = wf.make_view(scene, cfg)
    assert wf.mesh_tier(scene, cfg) == "heap-rg"
    assert isinstance(view.packet, cb.HeapTables)
    o, d = cam.generate_rays(torch.arange(cfg.num_pixels, device=dev), 0,
                             cfg.nx, cfg.ny)
    tm = torch.full((cfg.num_pixels,), FLT_MAX, device=dev)
    call = lambda: crg.rg_trace(o, d, tm, view.packet, cfg.epsilon)
    call()  # built and loaded
    before = crg.LAUNCHES["nearest"]
    with _op_recorder() as ops:
        call()
    assert crg.LAUNCHES["nearest"] == before + 1
    assert sorted(ops.ops) == ["empty", "empty", "empty", "expand"]


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
@pytest.mark.parametrize("n,ppl", [(40_000, 64), (196_608, 64),
                                   (40_003, 33)],
                         ids=["soup", "pool", "ragged"])
def test_iter_ablate_kernel_bit_equal(dev, n, ppl):
    """K13's three modes against their plain walks: acc and per-ray
    counters bit-equal; every mode visits the same nodes and leaves. On a
    random soup, at the dragon frame's 196,608-lane pool, and on 33-slot
    leaves (no multiple of a pair's 16 lanes) with n no multiple of a
    block; no culling and with closest held at each ray's K5 hit t."""
    mesh, o, d, tm = _bvh_inputs(dev, n=n, seed=7, ppl=ppl)
    tabs = cb.heap_tables(mesh)
    before = dict(ia.LAUNCHES)
    hit_t = cb.heap_trace(o, d, tm, tabs, T_MIN)[0]
    for t_max in (torch.full_like(tm, FLT_MAX), tm, hit_t):
        cnts = []
        for mode in ia.MODES:
            acc, cnt = ia.ablate_trace(o, d, t_max, tabs, T_MIN, mode)
            p_acc, p_cnt = ia._ablate_ref(o, d, t_max, tabs, T_MIN, mode)
            torch.cuda.synchronize()
            assert torch.equal(acc, p_acc) and torch.equal(cnt, p_cnt)
            # at K5's hit t no slot passes: full's acc is 0 there too
            assert (acc != 0).any() == (mode == "nomt" or (
                mode == "full" and t_max is not hit_t))
            cnts.append(cnt)
        assert all(torch.equal(c, cnts[0]) for c in cnts)
    assert not cnt[:, ::7].any()
    assert all(ia.LAUNCHES[m] == before[m] + 3 for m in ia.MODES)


DUAL_CASES = ("ragged", "n0", "n1", "n31", "n33", "wave_less_one",
              "first_leaf_1", "zero_direction", "non_finite_origins",
              "wave4_plus_33", "r1_lanes", "r1_lanes_plus_one", "r2_lanes",
              "r2_lanes_plus_one", "r4_lanes", "r4_lanes_plus_one")


def _dual_case(dev, case):
    """K16's inputs for ``case``: a random soup's heap (64 a leaf) and
    rays; ``ragged``: 40,003 rays; ``n0`` .. ``n33``: that many;
    ``wave_less_one``: one ray less than the R = 1 wave's lanes (every
    lane but the last takes one ray, none a second); ``wave4_plus_33``:
    33 rays more than R = 4 seats with no counter (every R refills);
    ``rR_lanes`` and ``rR_lanes_plus_one``: as many rays as R seats with
    no counter, and one more (its first refill); ``first_leaf_1``: the
    root a leaf (every ray pops at once); ``zero_direction``: a third of
    the rays with a zero direction component (1 / 0 = inf) and -0 in
    another; ``non_finite_origins``: NaN and inf origin components."""
    n = {"n0": 0, "n1": 1, "n31": 31, "n33": 33}.get(case, 40_003)
    if case == "wave_less_one":
        n = dp.lanes(1) - 1
    elif case == "wave4_plus_33":
        n = 4 * dp.lanes(4) + 33
    elif case.endswith("_lanes") or case.endswith("_lanes_plus_one"):
        r = int(case[1])
        n = r * dp.lanes(r) + case.endswith("_plus_one")
    mesh, o, d, _ = _bvh_inputs(dev, n=n, seed=8, ppl=64)
    tabs = cb.heap_tables(mesh)
    if case == "first_leaf_1":
        tabs = tabs._replace(nodes=tabs.nodes[:2].contiguous(), first_leaf=1)
    elif case == "zero_direction":
        d.x[::3] = 0.0
        d.y[1::3] = -0.0
    elif case == "non_finite_origins":
        o.x[::7] = float("nan")
        o.y[1::7] = float("inf")
        o.z[2::7] = -float("inf")
    return o, d, tabs


@pytest.mark.gpu
@pytest.mark.parametrize("case", DUAL_CASES)
def test_dual_probe_kernel_bit_equal(dev, case):
    """K16 at R = 1, 2 and 4 against the plain node phase, bit for bit, on
    each of DUAL_CASES (``_dual_case``); every launch counted."""
    o, d, tabs = _dual_case(dev, case)
    want = dp._dual_steps_ref(o, d, tabs)
    before = dict(dp.LAUNCHES)
    for r in dp.RAYS_PER_THREAD:
        assert torch.equal(dp.dual_steps(o, d, tabs, r), want), r
    n = o.x.shape[0]
    assert all(dp.LAUNCHES[k] == before[k] + (n > 0) for k in dp.LAUNCHES)
    if case == "ragged":
        assert int(want.min()) >= 1 and int(want.max()) > 10
    if case == "first_leaf_1":
        assert not want.any()


@pytest.mark.gpu
def test_dual_probe_counter_resets_in_graph_replays(dev):
    """Two replays of one captured CUDA graph of K16 at each R give the
    plain counts on more rays than any R's wave seats with no counter:
    the C entry zeroes the ray counter on the stream in every call, so no
    replay starts where the last one ended."""
    o, d, tabs = _dual_case(dev, "wave4_plus_33")
    want = dp._dual_steps_ref(o, d, tabs)
    for r in dp.RAYS_PER_THREAD:
        dp.dual_steps(o, d, tabs, r)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dp.dual_steps(o, d, tabs, r)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = dp.dual_steps(o, d, tabs, r)
        for _ in range(2):
            got.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(got, want), r


@pytest.mark.gpu
@pytest.mark.parametrize("name", yardsticks.names("dual_probe.cu"))
def test_dual_probe_yardsticks_bit_equal(dev, name):
    """Each K16 yardstick (a patch of ``csrc/dual_probe.cu``) builds and
    is bit-equal to the plain node phase at every R on the ragged and
    first_leaf_1 cases, uncounted."""
    lib = dp.bind(ctypes.CDLL(str(common.build(
        f"test_dual_{name}", yardsticks.source(name), None)[0])))
    before = dict(dp.LAUNCHES)
    for case in ("ragged", "first_leaf_1"):
        o, d, tabs = _dual_case(dev, case)
        want = dp._dual_steps_ref(o, d, tabs)
        for r in dp.RAYS_PER_THREAD:
            assert torch.equal(dp._walk(o, d, tabs, r, lib), want), (case, r)
    assert dp.LAUNCHES == before


@pytest.mark.gpu
def test_dual_probe_trace_counts_the_refills(dev):
    """The ``dual_trace`` yardstick's counters (``dual_probe.trace``) on
    more rays than any R's wave seats with no counter: at every R rays
    are seated after the first pass, by refill rounds and claims, and the
    warp that walks the longest ray runs at least its steps."""
    lib = dp.bind(ctypes.CDLL(str(common.build(
        "test_dual_trace", yardsticks.source("dual_trace"), None)[0])))
    o, d, tabs = _dual_case(dev, "wave4_plus_33")
    want = dp._dual_steps_ref(o, d, tabs)
    for r in dp.RAYS_PER_THREAD:
        tr = dp.trace(lib, o, d, tabs, r, want)
        assert tr["latest"] > 0 and tr["longest_seated"] <= tr["latest"], tr
        assert tr["passes"] >= int(want.max()) and tr["mean_passes"] > 0
        assert 0 < tr["claim_share"] <= tr["refill_share"] <= 1, tr


@pytest.mark.gpu
def test_dual_probe_waves_keep_the_warps_an_sm(dev):
    """Every R form launches one wave of the same blocks, all resident at
    once (the occupancy calculator's blocks an SM at least the wave's),
    so the resident warps an SM are equal at R = 1, 2 and 4; its build's
    walk loop holds the refill's one atomic (``walk_sass``)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = {r: dp.wave(r) for r in dp.RAYS_PER_THREAD}
    warps = {r: dp.warps_per_sm(r) for r in dp.RAYS_PER_THREAD}
    assert len(set(warps.values())) == 1, warps
    for grid, per_sm, resident in waves.values():
        assert grid == sms * per_sm and resident >= per_sm
    sass = dp.walk_sass(common.sass_dump(_build.build("dual_probe")))
    assert set(sass) == set(dp.RAYS_PER_THREAD)
    assert all(c[2] == 1 for c in sass.values()), sass


LEAFMT_VISITS = (0, 1, 2, 7, 611, 612, 1153)


def _leafmt_equal(run, tiles, dev, mode):
    """``run`` (a launch of K14's C entry) bit-equal to the plain version
    in ``mode`` at ``tiles`` tiles of the probe's inputs and at each of
    LEAFMT_VISITS: the db ring's first phases (0, 1, 2 visits), the 611
    clusters' wrap (611, 612) and an odd count past it (1153)."""
    args = lm.probe_inputs(tiles, dev)
    for visits in LEAFMT_VISITS:
        k = run(*args, visits, mode)
        p = lm._leafmt_ref(*args, visits, mode)
        torch.cuda.synchronize()
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]), visits
    assert (k[1] >= 0).any()
    assert torch.equal(k[0][:lm.TILE], k[0][-lm.TILE:])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", lm.MODES)
def test_leafmt_kernel_bit_equal(dev, mode):
    """K14 in each mode against its plain version on the probe's inputs,
    closest and besti bit-equal, at two tiles and at the dragon's
    196,608-lane pool (192 tiles, a wave and a half of blocks), at 0 to
    1153 visits (``_leafmt_equal``); cond with its branch never taken runs
    no visit."""
    before = lm.LAUNCHES[mode]
    for tiles in (2, lm.POOL_TILES):
        _leafmt_equal(lm.leafmt_run, tiles, dev, mode)
    assert lm.LAUNCHES[mode] == before + 2 * len(LEAFMT_VISITS)
    if mode == "cond":
        args = lm.probe_inputs(2, dev)
        closest, best = lm.leafmt_run(*args, 7, mode, skip=1)
        assert (best == -1).all() and torch.equal(closest, args[2])


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["kBulk:0", "kDmaL1:0", "kProxyFence:0"])
def test_leafmt_variants_bit_equal(dev, spec):
    """K14's variants the A/B times, built through ``common.variant``: the
    db ring filled by the lanes' cp.async (kBulk 0), dma's rows read at
    the L2 only (kDmaL1 0), the refill without its proxy fence; each mode
    bit-equal at two tiles and at the pool, not counted in LAUNCHES."""
    own = (_build.CSRC_DIR / "leafmt_probe.cu").read_text()
    name = "test_" + spec.split(":")[0]
    lib, _ = lm.source_lib(name, common.variant(own, spec))
    before = dict(lm.LAUNCHES)
    run = lambda *a: lm._launch(*a, lib=lib)
    for mode in lm.TIMED:
        for tiles in (2, lm.POOL_TILES):
            _leafmt_equal(run, tiles, dev, mode)
    assert lm.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", leafmt_cases.CASES)
def test_leafmt_cases_kernel_bit_equal(dev, name):
    """tests/leafmt_cases.py on the card: equal t at two slots, zero and
    NaN rows, dead lanes, a later visit's t equal to closest; K14 in
    every mode bit-equal to its plain version at 1, 2 and 3 visits."""
    blocks, o, d, tmax = leafmt_cases.case(name)
    args = (V3(*(torch.from_numpy(c).to(dev) for c in o)),
            V3(*(torch.from_numpy(c).to(dev) for c in d)),
            torch.from_numpy(tmax).to(dev),
            lm.clusters_from_blocks(blocks).to(dev))
    for mode in lm.MODES:
        for visits in (1, 2, 3):
            k = lm.leafmt_run(*args, visits, mode)
            p = lm._leafmt_ref(*args, visits, mode)
            assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        assert (k[1] >= 0).any()


@pytest.mark.gpu
def test_leaf_probe_sass_forms(dev):
    """The builds' SASS: K14 in the 16-lane split with db's bulk copy and
    mbarrier wait (``mode_sass``), K15's chain loops each with one bulk
    copy and one wait (``copy_sass``)."""
    sass = lm.mode_sass(common.sass_dump(_build.build("leafmt_probe")))
    assert set(sass) == set(lm.TIMED)
    assert all(50 <= slot <= 90 for slot, _, _ in sass.values())
    chain = dm.copy_sass(common.sass_dump(_build.build("dma_probe")))
    assert {m: c[1:] for m, c in chain.items()} == {"sync": (1, 1),
                                                     "db": (1, 1)}


@pytest.mark.gpu
def test_dma_probe_kernel_bit_equal(dev):
    """K15a and K15b against the plain in-order sum, bit for bit: no copy,
    the two barriers' first phases (1, 2, 3 copies), past the 2048
    clusters' wrap (2049, 4097) and at the probe's lower slope point."""
    blocks = dm.probe_blocks(device=dev)
    before = dict(dm.LAUNCHES)
    ks = (0, 1, 2, 3, 1000, 2049, 4097, dm.COPIES[0])
    for k in ks:
        want = dm._dma_chain_ref(blocks, k)
        for mode in dm.MODES:
            assert torch.equal(dm.dma_chain(blocks, k, mode), want)
    assert all(dm.LAUNCHES[m] == before[m] + len(ks) for m in dm.MODES)


@pytest.fixture(scope="module")
def micro():
    """The TPU file's inputs and ``tpu_micro._runs`` of every kernel, with
    K17a's runs in both modes on each case of micro_cases.GATHER_CASES
    (keyed by mode and case name)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    inp = um.probe_inputs(dev)
    runs = um._runs(inp, um.KERNELS)
    for name in micro_cases.GATHER_CASES:
        table, idx = (torch.from_numpy(a).to(dev)
                      for a in micro_cases.gather_case(name))
        for m in um.GATHER_MODES:
            kern = lambda s, t=table, i=idx, m=m: um.gather_chain(t, i, s, m)
            runs[(f"e3_{m}", name)] = um.Run(
                "E3", kern, lambda s, t=table, i=idx: um._gather_ref(t, i, s),
                None, kern)
    return inp, runs


@pytest.mark.gpu
@pytest.mark.parametrize("key", [("e3_l2", 1024), ("e3_l2", 131_072),
                                 ("e3_smem", 1024), ("e3_smem", 131_072),
                                 ("e7", 256), ("e7", 131_072), ("e4", 1024),
                                 ("e5", 128), ("e8", 1024), ("e9", 1024)]
                         + [(f"e3_{m}", c) for c in micro_cases.GATHER_CASES
                            for m in ("l2", "smem")])
def test_tpu_micro_kernel_bit_equal(micro, key):
    """K17a-K20, each mode at the TPU shape and (K17a, K17c) at 131,072
    lanes, and K17a in both modes on each of micro_cases.GATHER_CASES (T =
    2 and 32,768, 32 to 131,072 lanes a row, an idx of T - 1), bit-equal to
    its plain version over a few steps (0 and 1 among them) and at the
    lower count of its pair for K17b (2,000 steps), K17c (50), K19 and
    K20 (200 leaves); the call timed in a graph (``Run.timed``) too."""
    _, runs = micro
    run = runs[key]
    exp, name = run.exp, key[0]
    before = um.LAUNCHES[name]
    lo = {"E4": 2000, "E7": 50, "E8": 200, "E9": 200}.get(exp)
    steps_list = (0, 1, 3, 17, 64) + ((lo,) if lo else ())
    for steps in steps_list:
        k, p = run.kern(steps), run.ref(steps)
        torch.cuda.synchronize()
        assert torch.equal(k, p), (key, steps)
    assert torch.equal(run.timed(3), run.ref(3))
    assert um.LAUNCHES[name] == before + len(steps_list) + 1
    if exp in ("E8", "E9"):
        assert (k < um.FAR).any() and (k == um.FAR).any()


@pytest.mark.gpu
def test_tpu_micro_wrappers_refuse_what_the_kernels_do_not_take(micro):
    inp, _ = micro
    table, idx, x = inp["table"], um.lanes_of(inp, "E3", False), inp["x"]
    blocks = inp["blocks"]
    with pytest.raises(TypeError):
        um.gather_chain(table, idx.float(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        um.gather_chain(table, inp["idx3"][:, ::2], 1)
    with pytest.raises(ValueError, match="multiple of 32"):
        um.gather_chain(table, idx[:, :100].contiguous(), 1)
    with pytest.raises(ValueError, match="power of two"):
        um.gather_chain(table[:, :1000].contiguous(), idx, 1)
    # K17a smem's bulk copy reads a 16-byte aligned table; l2 reads words
    flat = torch.empty(table.numel() + 1, device=table.device)
    shifted = flat[1:].view(table.shape)
    shifted.copy_(table)
    with pytest.raises(ValueError, match="16-byte aligned"):
        um.gather_chain(shifted, idx, 1, "smem")
    assert torch.equal(um.gather_chain(shifted, idx, 3),
                       um._gather_ref(table, idx, 3))
    with pytest.raises(ValueError, match="shape"):
        um.onehot_chain(table[:4].contiguous(),
                        um.lanes_of(inp, "E7", False), 1)
    for name in micro_cases.REFUSED:  # C-20: not finite in bf16
        bad = torch.from_numpy(micro_cases.refused_table(name)).to(table)
        before = dict(um.LAUNCHES)
        with pytest.raises(ValueError, match="C-20"):
            um.onehot_chain(bad, um.lanes_of(inp, "E7", False), 1)
        assert um.LAUNCHES == before
    with pytest.raises(TypeError):
        um.row_vote_chain(inp["rows"], x.double(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        um.row_vote_chain(inp["rows"], x.t().contiguous().t(), 1)
    with pytest.raises(ValueError, match="shape"):
        um.copy_chain(blocks[:, :8].contiguous(), 1)
    with pytest.raises(ValueError, match="shape"):
        um.leaf_chain(blocks, x.reshape(-1), 1)
    with pytest.raises(ValueError, match="devices"):
        um.leaf_chain(blocks, x.cpu(), 1)
    # K19's bulk copy reads 16-byte aligned clusters; K20 reads words
    leaf = blocks[:um.LEAF_CLUSTERS]
    flat = torch.empty(leaf.numel() + 1, device=blocks.device)
    shifted = flat[1:].view(leaf.shape)
    shifted.copy_(leaf)
    with pytest.raises(ValueError, match="16-byte aligned"):
        um.leaf_chain(shifted, x, 1, "E8")
    assert torch.equal(um.leaf_chain(shifted, x, 3, "E9"),
                       um._leaf_ref(leaf, x, 3, "lanes"))
    with pytest.raises(ValueError, match="contiguous"):
        um.leaf_chain(leaf, x.t().contiguous().t(), 1, "E9")
    with pytest.raises(ValueError, match="at least one cluster"):
        um.leaf_chain(leaf[:0], x, 1, "E8")
    with pytest.raises(TypeError):
        um.leaf_chain(leaf.double(), x, 1, "E9")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(micro_cases.COPY_CASES))
def test_tpu_micro_copy_edge_inputs_bit_equal(dev, name):
    """K18 on tests/micro_cases.py's edge inputs (int(acc[0]) negative,
    a multiple of 3 and saturated; C = 1; one step), bit-equal to its
    plain version at the case's steps and below."""
    blocks = torch.from_numpy(micro_cases.copy_blocks(name)).to(dev)
    for steps in {0, 1, 2, micro_cases.COPY_CASES[name]}:
        k, p = um.copy_chain(blocks, steps), um._copy_ref(blocks, steps)
        torch.cuda.synchronize()
        assert torch.equal(k, p), (name, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(micro_cases.VOTE_CASES))
def test_tpu_micro_vote_cases_bit_equal(dev, name):
    """K17b on tests/micro_cases.py's E4 cases (a NaN row word, 0 x inf,
    a NaN lane, near = +0, 0/1/17 steps, T = 2), bit-equal to its plain
    version with NaN equal to NaN at 0, 1 and the case's steps."""
    rows, x = (torch.from_numpy(a).to(dev)
               for a in micro_cases.vote_case(name))
    for k in sorted({0, 1, micro_cases.VOTE_CASES[name]}):
        got, want = um.row_vote_chain(rows, x, k), um._row_vote_ref(rows, x, k)
        torch.cuda.synchronize()
        assert um.same(got, want), (name, k, um.differ(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(micro_cases.ONEHOT_CASES))
def test_tpu_micro_onehot_cases_bit_equal(dev, name):
    """K17c on tests/micro_cases.py's E7 cases (ties to even, the largest
    finite bf16, -0, int(acc[0]) saturated, T = 2 at 1 lane), bit-equal to
    its plain version at 0, 1 and the case's steps; its view build
    bit-equal to the plain view."""
    table, idx = (torch.from_numpy(a).to(dev)
                  for a in micro_cases.onehot_case(name))
    view = um.onehot_view(table)
    assert torch.equal(view.view(torch.int16),
                       um._view_ref(table).view(torch.int16))
    for k in sorted({0, 1, micro_cases.ONEHOT_CASES[name]}):
        got, want = um.onehot_chain(table, idx, k), um._onehot_ref(table, idx,
                                                                    k)
        torch.cuda.synchronize()
        assert um.same(got, want), (name, k, um.differ(got, want))


@pytest.mark.gpu
def test_tpu_micro_vote_and_onehot_sass(dev):
    """K17b's step loop holds one block-wide barrier, K17c's one 16 B load
    a lane (``vote_sass``, ``onehot_sass`` on the package's build), K17a
    smem's build one bulk copy, one mbarrier wait and no staging loop
    (``gather_sass``), and every kVoteWarps, both K17c block sizes and
    each yardstick of ``experiments/yardsticks`` that patches
    ``tpu_micro.cu`` build and are bit-equal to the plain version on the
    seeded inputs (K17a at 131,072 lanes but ``gather_noload``, which
    leaves the gather out), uncounted."""
    dump = common.sass_dump(_build.build("tpu_micro"))
    assert um.vote_sass(dump)[1] == 1
    assert um.onehot_sass(dump)[1:] == (1, 1)
    assert um.gather_sass(dump)["smem"][2:] == (1, 1, 0)
    own = (_build.CSRC_DIR / "tpu_micro.cu").read_text()
    inp = um.probe_inputs(dev)
    idx = um.lanes_of(inp, "E7", False)
    texts = {f"w{w}": common.variant(own, f"kVoteWarps:{w}")
             for w in um.VOTE_WARPS}
    texts.update({f"t{t}": common.variant(own, f"kOnehotThreads:{t}")
                  for t in (32, 256)})
    texts.update({n: yardsticks.source(n)
                  for n in yardsticks.names("tpu_micro.cu")})
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(texts)) as ex:  # one nvcc a source
        libs = list(ex.map(lambda kv: um.source_lib(f"test_{kv[0]}",
                                                    kv[1])[0],
                           texts.items()))
    before = dict(um.LAUNCHES)
    gather = um.lanes_of(inp, "E3", True)
    for name, lib in zip(texts, libs):
        for k in (1, 3, 64):
            assert torch.equal(um._row_vote(inp["rows"], inp["x"], k, lib),
                               um._row_vote_ref(inp["rows"], inp["x"], k))
            assert torch.equal(um._onehot(inp["table"], idx, k, lib),
                               um._onehot_ref(inp["table"], idx, k))
            if name == "gather_noload":  # another function: no gather
                continue
            for m in um.GATHER_MODES:
                assert torch.equal(um._gather(inp["table"], gather, k, m,
                                              lib),
                                   um._gather_ref(inp["table"], gather, k))
    assert um.LAUNCHES == before


@pytest.mark.gpu
def test_tpu_micro_copy_sass_and_fence_variant(dev):
    """K18's chain loop holds one bulk copy and one mbarrier wait
    (``tpu_micro.copy_sass``), and its build without the proxy fence
    (the A/B's ``kProxyFence:0``) is bit-equal too, uncounted."""
    chain = um.copy_sass(common.sass_dump(_build.build("tpu_micro")))
    assert chain[1:] == (1, 1)
    own = (_build.CSRC_DIR / "tpu_micro.cu").read_text()
    lib, _ = um.source_lib("test_nofence",
                           common.variant(own, "kProxyFence:0"))
    blocks = um.probe_inputs(dev)["blocks"]
    before = dict(um.LAUNCHES)
    for steps in (1, 3, 2000):
        assert torch.equal(um._copy(blocks, steps, lib),
                           um._copy_ref(blocks, steps))
    assert um.LAUNCHES == before


@pytest.fixture(scope="module")
def leaf_split_libs():
    """{(lanes a ray, rays a block): library} of csrc/tpu_micro.cu with
    both leaf kernels at every split it takes (``tpu_micro.LEAF_SPLITS``),
    built in parallel; their launches are not counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    from concurrent.futures import ThreadPoolExecutor
    own = (_build.CSRC_DIR / "tpu_micro.cu").read_text()
    spec = "kE8Lanes:{0},kE8Rays:{1},kE9Lanes:{0},kE9Rays:{1}"
    with ThreadPoolExecutor(len(um.LEAF_SPLITS)) as ex:
        libs = ex.map(lambda sr: um.source_lib(
            f"test_split_{sr[0]}_{sr[1]}",
            common.variant(own, spec.format(*sr)))[0], um.LEAF_SPLITS)
    return dict(zip(um.LEAF_SPLITS, libs))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(leaf_cases.LEAF_CASES))
def test_tpu_micro_leaf_edge_cases_bit_equal(dev, leaf_split_libs, name):
    """K19 and K20 on tests/leaf_cases.py's edge inputs (a chain on 2^31 -
    1, a tie across a split's lanes, the f = 1 path, t at 0.001, C = 1, 0
    and 1 leaves), bit-equal to the plain version in their modes at 0, 1
    and the case's leaves: the package's build (counted) and every split
    the source takes (uncounted)."""
    blocks, x, steps = leaf_cases.leaf_case(name)
    blocks = torch.from_numpy(blocks).to(dev)
    x = torch.from_numpy(x).to(dev)
    for k in sorted({0, 1, steps}):
        for exp, mode in um.LEAF_MODES.items():
            want = um._leaf_ref(blocks, x, k, mode)
            before = um.LAUNCHES[exp.lower()]
            assert torch.equal(um.leaf_chain(blocks, x, k, exp), want)
            assert um.LAUNCHES[exp.lower()] == before + 1
            for split, lib in leaf_split_libs.items():
                got = um._leaf(blocks, x, k, exp, lib)
                assert torch.equal(got, want), (exp, split, k)
            assert um.LAUNCHES[exp.lower()] == before + 1


@pytest.mark.gpu
def test_tpu_micro_leaf_launch_and_sass(dev, leaf_split_libs):
    """K19 and K20 spread over the card (more than one block, 1024 rays in
    all) at every split, and their SASS: K19's leaf loops hold the bulk
    copy and the mbarrier wait, K20's neither; ``leaf_sass`` counts both
    kernels' loops (a consumer's tests and merge at its lanes a ray)."""
    for split, lib in [(None, None), *leaf_split_libs.items()]:
        for exp in um.LEAF_MODES:
            blocks, threads, smem = um.leaf_shape(exp, lib)
            assert blocks > 1, (exp, split)
            if split:
                lanes, rays = split
                assert blocks * rays == um.TILE
                assert threads == 32 + rays * lanes
    dump = common.sass_dump(_build.build("tpu_micro"))
    code = {n: c for n, c in common.sass_functions(dump).items()
            if "leaf_" in n}
    ops = {("E8" if "leaf_smem" in n else "E9"):
           {common.opcode(i) for _, i in c} for n, c in code.items()}
    for op in (common.BULK_COPY, common.BARRIER_WAIT):
        assert any(o.startswith(op) for o in ops["E8"])
        assert not any(o.startswith(op) for o in ops["E9"])
    sass = um.leaf_sass(dump)
    for exp, lanes in um.LEAF_LANES.items():
        consumer, tests, merge, producer = sass[exp]
        assert tests == um.BLOCK[1] // lanes
        assert merge == (1 if lanes == 32 else int(np.log2(lanes)))
        assert consumer > 0 and producer > 0


@pytest.mark.gpu
@pytest.mark.parametrize("exp", ["E8", "E9"])
def test_tpu_micro_leaf_chain_through_a_lane_that_misses(micro, exp):
    """Lane 0's o1 NaN: it never hits, and the chain runs on int(1e30),
    which the kernel's cvt.rzi saturates to 2147483647 as the plain
    version does."""
    inp, _ = micro
    blocks, x = inp["blocks"][:um.LEAF_CLUSTERS], inp["x"].clone()
    x[0, 0] = float("nan")
    for steps in (2, 17):
        k = um.leaf_chain(blocks, x, steps, exp)
        p = um._leaf_ref(blocks, x, steps, um.LEAF_MODES[exp])
        torch.cuda.synchronize()
        assert torch.equal(k, p) and k[0, 0] == um.FAR


@pytest.mark.gpu
@pytest.mark.parametrize("upto", rp.UPTOS)
def test_regroup_kernel_bit_equal(dev, upto):
    """K21 in each mode on one window, on 3 repeats and on 2 blocks."""
    inp = rp.probe_inputs(dev)
    before = rp.LAUNCHES[upto]
    want = rp._regroup_plain(inp, upto)
    for windows, blocks in ((1, 1), (3, 1), (1, 2)):
        got = rp.regroup_window(inp, upto, windows, blocks)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w.repeat(blocks, 1, 1))
                   for g, w in zip(got, want)), (windows, blocks)
    assert rp.LAUNCHES[upto] == before + 3


@pytest.mark.gpu
def test_regroup_kernel_bit_equal_with_empty_visits(dev):
    inp = rp.probe_inputs(dev)
    inp["masks"][5:7] = 0.0
    counts = (inp["masks"].reshape(rp.K, -1) > 0.5).sum(1).cpu()
    inp["vpref"][1:] = torch.cumsum(counts, 0).to(torch.int32)
    for upto in rp.UPTOS:
        got, want = rp.regroup_window(inp, upto), rp._regroup_plain(inp, upto)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), upto


def _regroup_equal(inp, run):
    """Every mode through ``run`` (a launch of K21's C entry: inp, upto,
    windows, blocks) bit-equal to the plain version on one window, 3 and
    the probe's 4 and 1028 repeats in one block, 2 blocks and card-wide
    (CARD_BLOCKS)."""
    for upto in rp.UPTOS:
        want = rp._regroup_plain(inp, upto)
        for windows, blocks in ((1, 1), (3, 1), (1, 2), *rp.CELLS):
            got = run(inp, upto, windows, blocks)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w.repeat(blocks, 1, 1))
                       for g, w in zip(got, want)), (upto, windows, blocks)


@pytest.mark.gpu
@pytest.mark.parametrize("name", regroup_cases.CASES)
def test_regroup_cases_bit_equal(dev, name):
    """tests/regroup_cases.py on the card: ties across visits and
    triangles, a ray only in visit 63, an empty visit between two, a ray
    in every visit, t equal to cl0; each crafted ray's winner the case's."""
    inp = regroup_cases.inputs(name, dev)
    before = rp.LAUNCHES["full"]
    _regroup_equal(inp, rp.regroup_window)
    assert rp.LAUNCHES["full"] == before + 6
    t, i = rp.regroup_window(inp, "full")
    for r, (tt, ii) in regroup_cases.EXPECT[name].items():
        assert (t.reshape(-1)[r].item(), i.reshape(-1)[r].item()) == (
            tt, ii), r


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["kSlotLanes:1,kRingStages:5",
                                  "kSlotLanes:2", "kSlotLanes:8",
                                  "kSlotLanes:16", "kSlotLanes:32",
                                  "kRingStages:2", "kRingStages:8",
                                  "kRingStages:3,kSlotLanes:16",
                                  "kUnroll:1", "kProxyFence:0"])
def test_regroup_variants_bit_equal(dev, spec):
    """K21 at every other kSlotLanes the source allows (1 with the 5
    stages its steps can span), with rings of 2, 3 and 8 stages, one test
    a lane at a time and without the proxy fence, built through
    ``common.variant``:
    every mode bit-equal on the seeded window and every case, not counted
    in LAUNCHES."""
    own = (_build.CSRC_DIR / "regroup_probe.cu").read_text()
    name = "test_" + spec.replace(":", "").replace(",", "_")
    lib, _ = rp.source_lib(name, common.variant(own, spec))
    before = dict(rp.LAUNCHES)
    run = lambda *a: rp._launch(*a, lib=lib)
    _regroup_equal(rp.probe_inputs(dev), run)
    for case in regroup_cases.CASES:
        _regroup_equal(regroup_cases.inputs(case, dev), run)
    assert rp.LAUNCHES == before


@pytest.mark.gpu
def test_regroup_sass_form(dev):
    """The build's SASS (``regroup_probe.mode_sass``): no shared-memory
    atomic in any mode; the staged modes hold the bulk copy and the
    mbarrier wait, mt and full their tests in a loop of their own."""
    sass = rp.mode_sass(common.sass_dump(_build.build("regroup_probe")))
    assert set(sass) == set(rp.UPTOS)
    for mode in ("mt", "full"):
        test, step, rank, rest = sass[mode]
        assert 40 <= test <= 120 and step > 0 and rank > 0
    assert 0 < rp.ring_bytes() <= 232_448 - 25_344  # beside the tables


@pytest.mark.gpu
def test_regroup_wrapper_refuses_what_the_kernel_does_not_take(dev):
    inp = rp.probe_inputs(dev)
    bad = lambda **kw: {**inp, **kw}
    with pytest.raises(TypeError):
        rp.regroup_window(bad(rays=inp["rays"].double()))
    with pytest.raises(ValueError, match="shape"):
        rp.regroup_window(bad(masks=inp["masks"][:32]))
    with pytest.raises(ValueError, match="contiguous"):
        rp.regroup_window(bad(tri=inp["tri"].t().contiguous().t()))
    vpref = inp["vpref"].clone()
    vpref[-1] = rp.S + 1
    with pytest.raises(ValueError, match="exceed"):
        rp.regroup_window(bad(vpref=vpref))
    with pytest.raises(ValueError, match="cpu"):
        rp.regroup_window(bad(cids=inp["cids"].to(dev)))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", lr.MODES)
@pytest.mark.parametrize("w", lr.WIDTHS)
def test_leafround_kernel_bit_equal(dev, mode, w):
    rays, blocks = lr.probe_inputs((w,), dev)
    before = lr.LAUNCHES[mode]
    counts = (0, 1, 3, 17, lr.ROUNDS_PAIR[0])
    got = {}
    for rounds in counts:
        got[rounds] = lr.leafround_run(rays, blocks[w], rounds, mode)
        want = lr._leafround_ref(rays, blocks[w], rounds, mode)
        torch.cuda.synchronize()
        assert torch.equal(got[rounds], want), rounds
    assert lr.LAUNCHES[mode] == before + len(counts)
    if mode == 2:  # after 17 rounds some lanes hit and some miss
        assert (got[17] < mr.FAR).any() and (got[17] == mr.FAR).any()


@pytest.mark.gpu
@pytest.mark.parametrize("w", lr.WIDTHS)
@pytest.mark.parametrize("name", list(multirow_cases.ROUND_CASES))
def test_leafround_cases_kernel_bit_equal(dev, name, w):
    """tests/multirow_cases.py's K22 cases on the card: the chain's two
    branches, a tie across the split, a = 0 and |a| < 1e-7, t = 0.001, a
    NaN origin, 0 and 1 rounds; every mode bit-equal to the plain version
    at 0, 1, the case's rounds and 17."""
    rays, blocks, n = multirow_cases.round_case(name, w)
    rays = torch.from_numpy(rays).to(dev)
    blocks = torch.from_numpy(blocks).to(dev)
    for mode in lr.MODES:
        for rounds in sorted({0, 1, n, 17}):
            got = lr.leafround_run(rays, blocks, rounds, mode)
            want = lr._leafround_ref(rays, blocks, rounds, mode)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (mode, rounds)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K23", "K24"])
@pytest.mark.parametrize("name", multirow_cases.WALK_CASES)
def test_walk_cases_kernel_bit_equal(dev, name, kernel):
    """tests/multirow_cases.py's walk cases on the card: the packed vote's
    extremes (pref -128, +128, 0; a pop; one child on each side), the
    bitstack through 0xFFFF and 0, the smallest tables; every fetch mode
    bit-equal to the plain version, acc and every step's idx and bs."""
    rays, tab, n = multirow_cases.walk_case(name, kernel)
    rays, tab = torch.from_numpy(rays).to(dev), torch.from_numpy(tab).to(dev)
    for mode in mr.MODES if kernel == "K23" else gp.MODES:
        for steps in (0, 1, 3, 17, n):
            if kernel == "K23":
                got = mr.multirow_run(rays, tab, steps, mode, trace=True)
                want = mr._multirow_ref(rays, tab, steps, mode)
            else:
                got = gp.gather_run(rays, tab, steps, mode, trace=True)
                want = gp._gather_ref(rays, tab, steps)
            torch.cuda.synchronize()
            assert all(torch.equal(g, q) for g, q in zip(got, want)), (
                mode, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["kRoundLanes:16,kRoundRays:8",
                                  "kRoundLanes:8,kRoundRays:8",
                                  "kRoundStages:1", "kRoundWhole:1",
                                  "kWalkWarps:1", "kWalkWarps:2",
                                  "kWalkWarpsFixed:4"])
def test_multirow_variants_bit_equal(dev, spec):
    """The variants the A/Bs time, built through ``common.variant``: K22
    at other splits (a partial-warp merge), one stage, the whole block
    copied; the walk at 1 and 2 warps a row, and K23 fixed at 4 (its
    vote across warps); each bit-equal to the plain version in every mode,
    not counted in LAUNCHES."""
    own = (_build.CSRC_DIR / "multirow_probes.cu").read_text()
    name = "test_" + spec.replace(":", "").replace(",", "_")
    lib = mr.source_lib(name, common.variant(own, spec))[0]
    before = (dict(lr.LAUNCHES), dict(mr.LAUNCHES), dict(gp.LAUNCHES))
    rays, blocks = lr.probe_inputs(lr.WIDTHS, dev)
    for w, b in blocks.items():
        for mode in lr.MODES:
            for rounds in (0, 1, 17, 256):
                got = lr._leafround(rays, b, rounds, mode, lib)
                want = lr._leafround_ref(rays, b, rounds, mode)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (w, mode, rounds)
    ntab, mrays = mr.probe_inputs(device=dev)
    grays, tabs = gp.probe_inputs((8, 128), dev)
    for steps in (0, 1, 17, 100):
        for mode in mr.MODES:
            got = mr._multirow(mrays, ntab, steps, mode, True, lib)
            want = mr._multirow_ref(mrays, ntab, steps, mode)
            torch.cuda.synchronize()
            assert all(torch.equal(g, q) for g, q in zip(got, want))
        for tab in tabs.values():
            want = gp._gather_ref(grays, tab, steps)
            for mode in gp.MODES:
                got = gp._gather(grays, tab, steps, mode, True, lib)
                torch.cuda.synchronize()
                assert all(torch.equal(g, q) for g, q in zip(got, want))
    assert (dict(lr.LAUNCHES), dict(mr.LAUNCHES), dict(gp.LAUNCHES)) == before


@pytest.mark.gpu
def test_multirow_sass_and_launch_forms(dev):
    """The build's SASS and launches: K22 in the spread form
    (``round_sass``: a consumer's and the producer's round loops, one
    REDUX.MIN each), mode 2 with the bulk copy and the mbarrier wait and
    modes 0/1 with neither; the walk's step loop with one REDUX.SUM
    (``walk_sass``); every launch over more than one block."""
    dump = common.sass_dump(_build.build("multirow_probes"))
    lanes = mr.source_constant(
        (_build.CSRC_DIR / "multirow_probes.cu").read_text(), "kRoundLanes")
    rounds = mr.round_sass(dump, lanes)
    assert set(rounds) == {(m, w) for m in lr.MODES for w in lr.WIDTHS}
    assert all(rounds[0, w][2] == 0 < rounds[2, w][2] for w in lr.WIDTHS)
    assert set(mr.walk_sass(dump)) == {("fixed", False),
                                       ("assemble", False),
                                       ("shfl", True), ("lanes", True)}
    for name, code in common.sass_functions(dump).items():
        if "leafround_kernel" not in name:
            continue
        ops = {common.opcode(i) for _, i in code}
        staged = "leafround_kernelILi2E" in name
        for op in (common.BULK_COPY, common.BARRIER_WAIT):
            assert any(o.startswith(op) for o in ops) == staged, (name, op)
    for mode in lr.MODES:
        for w in lr.WIDTHS:
            assert lr.round_shape(mode, w)[0] > 1
    for fetch in ("fixed", "assemble", "shfl", "lanes"):
        assert mr.walk_shape(fetch)[0] > 1


@pytest.mark.gpu
def test_leafround_wrapper_refuses_what_the_kernel_does_not_take(dev):
    rays, blocks = lr.probe_inputs((32,), dev)
    b = blocks[32]
    with pytest.raises(ValueError, match="widths"):
        lr.leafround_run(rays, b[:, :2].contiguous(), 1)
    with pytest.raises(ValueError, match="shape"):
        lr.leafround_run(rays, b[:512], 1)
    with pytest.raises(TypeError):
        lr.leafround_run(rays.double(), b, 1)
    with pytest.raises(ValueError, match="devices"):
        lr.leafround_run(rays.cpu(), b, 1)
    # mode 2's bulk copy reads 16-byte aligned clusters
    shifted = torch.empty(b.numel() + 1, device=dev)[1:].view(b.shape)
    shifted.copy_(b)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lr.leafround_run(rays, shifted, 1, 2)
    assert torch.equal(lr.leafround_run(rays, shifted, 3, 0),
                       lr._leafround_ref(rays, shifted, 3, 0))
    with pytest.raises(ValueError, match="2\\^31"):
        lr.leafround_run(rays, b, 2 ** 31, 2)
    with pytest.raises(ValueError, match="contiguous"):
        lr.leafround_run(rays.transpose(1, 2).contiguous().transpose(1, 2),
                         b, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", mr.MODES)
def test_multirow_kernel_bit_equal(dev, mode):
    ntab, rays = mr.probe_inputs(device=dev)
    before = mr.LAUNCHES[mode]
    for steps in (0, 1, 3, 17, 64):
        got = mr.multirow_run(rays, ntab, steps, mode, trace=True)
        want = mr._multirow_ref(rays, ntab, steps, mode)
        torch.cuda.synchronize()
        assert all(torch.equal(g, p) for g, p in zip(got, want)), steps
        acc, _, _ = mr.multirow_run(rays, ntab, steps, mode)
        assert torch.equal(acc, want[0])
    assert mr.LAUNCHES[mode] == before + 10


@pytest.mark.gpu
@pytest.mark.parametrize("mode", gp.MODES)
@pytest.mark.parametrize("s", [8, 16, 128])
def test_gather_kernel_bit_equal(dev, mode, s):
    rays, tabs = gp.probe_inputs((s,), dev)
    for steps in (0, 1, 3, 17, 64, 100, gp.STEPS[0]):
        got = gp.gather_run(rays, tabs[s], steps, mode, trace=True)
        want = gp._gather_ref(rays, tabs[s], steps)
        torch.cuda.synchronize()
        assert all(torch.equal(g, p) for g, p in zip(got, want)), steps


@pytest.mark.gpu
def test_walk_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ntab, rays = mr.probe_inputs(device=dev)
    with pytest.raises(ValueError, match="power of two"):
        mr.multirow_run(rays, ntab[:6 * 1000].contiguous(), 1)
    with pytest.raises(TypeError):
        mr.multirow_run(rays, ntab.double(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        mr.multirow_run(rays.transpose(1, 2).contiguous().transpose(1, 2),
                        ntab, 1)
    _, tabs = gp.probe_inputs((8,), dev)
    with pytest.raises(ValueError, match="power of two"):
        gp.gather_run(rays, torch.zeros((12, 3, 8, 128), device=dev), 1)
    with pytest.raises(ValueError, match="dimensions"):
        gp.gather_run(rays, tabs[8].reshape(12, -1), 1)
    with pytest.raises(ValueError, match="steps"):
        gp.gather_run(rays, tabs[8], -1)
    # the C entry takes the steps as an int
    with pytest.raises(ValueError, match="2\\^31"):
        gp.gather_run(rays, tabs[8], 2 ** 31)
    with pytest.raises(ValueError, match="2\\^31"):
        mr.multirow_run(rays, ntab, 2 ** 31)
    with pytest.raises(ValueError, match="contiguous"):
        gp.gather_run(rays, tabs[8].transpose(2, 3).contiguous()
                      .transpose(2, 3), 1)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["tpu", "ragged", "pool"])
def test_sphere_layout_kernels_bit_equal(dev, which):
    """K25a (all slots and the first 100) and K25b against their plain
    versions and K1: the TPU file's 16,384 rays, 1000 of them (a ragged
    block), and the headline's 32,768-lane pool."""
    inp = (sl.frame_sets(dev)["pool primary"] if which == "pool"
           else sl.probe_inputs(dev, sl.M if which == "tpu" else 1000))
    rays, sph, feat_t = inp["rays"], inp["sph"], inp["feat_t"]
    m = rays.shape[1]
    before = dict(sl.LAUNCHES)
    for n_s in (sl.S, 100):
        got, want = sl.spheres_sb(rays, sph, n_s=n_s), sl.sb_plain(
            rays, sph, n_s=n_s)
        torch.cuda.synchronize()
        assert all(torch.equal(g, p) for g, p in zip(got, want)), n_s
    got = sl.spheres_sbf(rays, sph, feat_t)
    want = sl.sbf_plain(rays, sph, feat_t)
    assert all(torch.equal(g, p) for g, p in zip(got, want))
    t, idx, f = sl._k1(inp)
    assert all(torch.equal(g, p) for g, p in zip(got, (t, idx,
                                                       torch.stack(f))))
    hits = int((got[1] >= 0).sum())
    # the pool's middle rows hit on every lane
    assert 0 < hits and (hits < m or which == "pool")
    assert sl.LAUNCHES == {"sb": before["sb"] + 2, "sbf": before["sbf"] + 1}


@pytest.mark.gpu
def test_sphere_layout_kernels_match_k1_on_the_headline(dev):
    """The headline's four sets, its 960,000 and 32,768-lane pool primary
    rays and their live bounce-2 rays: both kernels bit-equal to K1 (t,
    idx; the features, 0 on a miss) and K25a to its plain version."""
    for inp in sl.frame_sets(dev).values():
        rays, sph = inp["rays"], inp["sph"]
        t, idx, f = sl._k1(inp)
        sb = sl.spheres_sb(rays, sph)
        assert torch.equal(sb[0], t) and torch.equal(sb[1], idx)
        sbf = sl.spheres_sbf(rays, sph, inp["feat_t"])
        assert all(torch.equal(g, p) for g, p in zip(sbf, (t, idx,
                                                           torch.stack(f))))
        assert all(torch.equal(g, p)
                   for g, p in zip(sb, sl.sb_plain(rays, sph)))


@pytest.mark.gpu
def test_sphere_layout_wrappers_refuse_what_the_kernels_do_not_take(dev):
    inp = sl.probe_inputs(dev, 1024)
    rays, sph, feat_t = inp["rays"], inp["sph"], inp["feat_t"]
    with pytest.raises(ValueError, match="shape"):
        sl.spheres_sb(rays, sph[:, :256].contiguous())
    with pytest.raises(ValueError, match="outside"):
        sl.spheres_sb(rays, sph, n_s=sl.S + 1)
    with pytest.raises(TypeError):
        sl.spheres_sb(rays.double(), sph)
    with pytest.raises(ValueError, match="devices|expected"):
        sl.spheres_sb(rays, sph.cpu())
    bad = feat_t.clone()
    bad[3, 10] = float("nan")
    with pytest.raises(ValueError, match="C-20"):
        sl.spheres_sbf(rays, sph, bad)


@pytest.mark.gpu
def test_shapecast_kernel_bit_equal(dev):
    """Every case alone and all 15 in one launch, bit-equal to the plain
    version (the A @ B^T case too: the plain version sums in the kernel's
    order)."""
    x = sc.probe_x(dev)
    want = sc.shapecast_plain(x)
    before = sc.LAUNCHES["cases"]
    assert torch.equal(sc.shapecast(x), want)
    for c in range(len(sc.NAMES)):
        assert torch.equal(sc.shapecast(x, c, 1)[0], want[c]), sc.NAMES[c]
    assert torch.equal(sc.shapecast(x, 7, 3), want[7:10])
    assert sc.LAUNCHES["cases"] == before + 2 + len(sc.NAMES)


@pytest.mark.gpu
def test_shapecast_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x = sc.probe_x(dev)
    with pytest.raises(ValueError, match="outside"):
        sc.shapecast(x, 10, 6)
    with pytest.raises(ValueError, match="shape"):
        sc.shapecast(x.reshape(1024, 1))
    with pytest.raises(TypeError):
        sc.shapecast(x.double())


@pytest.mark.gpu
def test_spheres_oracle_gate_on_the_card(dev):
    """bench.py's spheres oracle gate (``_oracle_gate``, :85) at 32x24,
    2 spp: the render through the sphere kernel against the port's NumPy
    oracle on the host, at the gate's bounds (rmse < 5e-3, SSIM >= 0.99);
    the frame launched K1."""
    from tpu_pathtracer_torch.oracle import render_oracle
    from tpu_pathtracer_torch.utils import golden

    cfg = RenderConfig(nx=32, ny=24, ns=2, max_depth=8)
    scene, cam = random_spheres_scene(cfg.nx, cfg.ny, device=dev)
    before = cs.LAUNCHES
    img = render_image_regen(scene, cam, cfg)
    assert cs.LAUNCHES > before
    ref = render_oracle(scene, cam, cfg)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert golden.rmse(img, ref) < 5e-3
    assert golden.ssim(img, ref) >= 0.99
