"""The CUDA sphere kernel against its plain PyTorch version, on the card.

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
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import cuda_spheres as cs
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
