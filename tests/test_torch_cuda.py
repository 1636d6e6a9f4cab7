"""The CUDA sphere and triangle kernels against their plain PyTorch
versions, on the card.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

(``--noconftest``: the suite's conftest configures JAX.)
"""

from unittest import mock

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.regen import render_image_regen
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
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
