"""The sphere kernel's plain PyTorch version against the JAX package's
Pallas kernel ``_kernel_sb`` (interpret mode), in all three modes, plus
the contract's edge cases (``tests/sphere_cases.py``). The CUDA kernel
itself runs only on a card: ``tests/test_torch_cuda.py`` holds it
against the plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops.pallas_spheres import (spheres_anyhit_soa as j_any,
                                               spheres_hit_feat as j_feat,
                                               spheres_hit_pallas as j_hit,
                                               spheres_hit_soa as j_soa)
from tpu_pathtracer.ops.v3 import V3 as JV3
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.wavefront import make_view
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX
from sphere_cases import CASES, T_MIN
from sphere_cases import case as _case
from sphere_cases import rays as _rays
from sphere_cases import spheres as _spheres
from sphere_cases import tv3 as _tv3
from torch_threads import one_torch_thread  # noqa: F401
# t: the JAX kernel and the plain version evaluate the same oc-form
# expressions, but XLA may contract a*b+c into an FMA on the CPU where
# PyTorch does not. Bound: the JAX test's own rtol 1e-5
# (test_pallas_kernels.py:123), plus, for grazing rays, a few ulps of
# b² carried through sqrt(b² − c): |Δt| <= 4·2⁻²³·b²/sqrt(disc).
T_RTOL = 1e-5


def _t_tol(o, d, c, r, idx, t):
    """Per-lane bound on |Δt| for the winner ``idx`` (see T_RTOL)."""
    hit = idx >= 0
    oc = o.astype(np.float64) - c[np.maximum(idx, 0)]
    b = np.sum(oc * d, axis=1)
    disc = b * b - (np.sum(oc * oc, axis=1) - r[np.maximum(idx, 0)] ** 2.0)
    graze = 4 * 2.0 ** -23 * b * b / np.sqrt(np.maximum(disc, 1e-30))
    return np.where(hit, T_RTOL * np.abs(t) + graze, 0.0)


def _jv3(a):
    return JV3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _tmax(t_max, n):
    return np.full(n, FLT_MAX, np.float32) if t_max is None else t_max


def _both_feat(o, d, c, r, feat, t_max=None):
    """(t, idx, [N, C] features) from JAX interpret mode and the port."""
    tm = _tmax(t_max, o.shape[0])
    jt, ji, jf = j_feat(_jv3(o), _jv3(d), _jv3(c), jnp.asarray(r),
                        jnp.asarray(feat), T_MIN, jnp.asarray(tm),
                        interpret=True)
    tt, ti, tf = cs.spheres_hit_feat(_tv3(o), _tv3(d), _tv3(c),
                                     torch.from_numpy(r),
                                     torch.from_numpy(feat), T_MIN,
                                     torch.from_numpy(tm))
    j = (np.asarray(jt), np.asarray(ji),
         np.stack([np.asarray(x) for x in jf], axis=1))
    t = (tt.numpy(), ti.numpy(), torch.stack(tf, dim=1).numpy())
    return j, t, _t_tol(o, d, c, r, t[1], t[0])


def _assert_feat_equal(j, t, tol):
    jt, ji, jf = j
    tt, ti, tf = t
    np.testing.assert_array_equal(ti, ji)          # idx exact
    assert (np.abs(tt - jt) <= tol).all()
    hit = ti >= 0
    np.testing.assert_array_equal(tf[hit], jf[hit])  # features exact
    assert (tt[~hit] == np.float32(FLT_MAX)).all()
    assert (tf[~hit] == 0).all()


def test_feat_mode_matches_pallas():
    o, d = _rays(384, seed=1)
    c, r, feat = _spheres(40, seed=2)
    j, t, tol = _both_feat(o, d, c, r, feat)
    _assert_feat_equal(j, t, tol)
    assert (t[1] >= 0).sum() > 60


def test_nearest_mode_matches_pallas():
    o, d = _rays(384, seed=3)
    c, r, _ = _spheres(40, seed=4)
    jt, ji = j_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                   jnp.asarray(r), T_MIN, FLT_MAX, interpret=True)
    tt, ti = cs.spheres_hit_soa(_tv3(o), _tv3(d), _tv3(c),
                                torch.from_numpy(r), T_MIN, FLT_MAX)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    tol = _t_tol(o, d, c, r, ti.numpy(), tt.numpy())
    assert (np.abs(tt.numpy() - np.asarray(jt)) <= tol).all()


def test_anyhit_mode_matches_pallas():
    o, d = _rays(384, seed=5)
    c, r, _ = _spheres(40, seed=6)
    t_near, idx = cs.spheres_hit_soa(_tv3(o), _tv3(d), _tv3(c),
                                     torch.from_numpy(r), T_MIN, FLT_MAX)
    # per-ray t_max: past the hit on even lanes, before it on odd lanes
    scale = np.where(np.arange(o.shape[0]) % 2 == 0, 1.001, 0.5)
    tm = np.where(idx.numpy() >= 0, t_near.numpy() * scale,
                  FLT_MAX).astype(np.float32)
    jo = np.asarray(j_any(_jv3(o), _jv3(d), _jv3(c), jnp.asarray(r), T_MIN,
                          jnp.asarray(tm), interpret=True))
    to = cs.spheres_anyhit_soa(_tv3(o), _tv3(d), _tv3(c),
                               torch.from_numpy(r), T_MIN,
                               torch.from_numpy(tm))
    assert to.dtype == torch.bool
    np.testing.assert_array_equal(to.numpy(), jo)
    assert 0 < to.numpy().sum() < (idx.numpy() >= 0).sum()


@pytest.mark.parametrize("name", CASES)
def test_contract_cases(name):
    """Each case of tests/sphere_cases.py in all three modes: the plain
    version against the Pallas kernel in interpret mode (idx, occlusion
    and features exact, t within _t_tol), then the case's own check."""
    o, d, c, r, tm, check = _case(name)
    feat = np.random.RandomState(13).uniform(
        -3, 3, (c.shape[0], 18)).astype(np.float32)
    j, t, tol = _both_feat(o, d, c, r, feat, tm)
    _assert_feat_equal(j, t, tol)
    check(t)
    tmv = _tmax(tm, o.shape[0])
    jt, ji = j_soa(_jv3(o), _jv3(d), _jv3(c), jnp.asarray(r), T_MIN,
                   jnp.asarray(tmv), interpret=True)
    jo = j_any(_jv3(o), _jv3(d), _jv3(c), jnp.asarray(r), T_MIN,
               jnp.asarray(tmv), interpret=True)
    np.testing.assert_array_equal(np.asarray(ji), t[1])
    assert (np.abs(np.asarray(jt) - t[0]) <= tol).all()
    # the other two modes of the port agree with its features mode
    args = (_tv3(o), _tv3(d), _tv3(c), torch.from_numpy(r), T_MIN,
            torch.from_numpy(tmv))
    t2, i2 = cs.spheres_hit_soa(*args)
    np.testing.assert_array_equal(i2.numpy(), t[1])
    np.testing.assert_array_equal(t2.numpy(), t[0])
    occ = cs.spheres_anyhit_soa(*args).numpy()
    np.testing.assert_array_equal(occ, np.asarray(jo))
    np.testing.assert_array_equal(occ, t[1] >= 0)


def test_cpu_tensors_take_the_plain_version():
    o, d = _rays(32, seed=14)
    c, r, feat = _spheres(8, seed=15)
    before = cs.LAUNCHES
    cs.spheres_hit_feat(_tv3(o), _tv3(d), _tv3(c), torch.from_numpy(r),
                        torch.from_numpy(feat), T_MIN, FLT_MAX)
    assert cs.LAUNCHES == before  # no kernel launched for CPU tensors


def test_make_view_builds_the_table_once():
    """make_view's prebuilt table is sphere_table of its columns, and the
    wrappers give the same results with it as without it."""
    cfg = RenderConfig(nx=16, ny=12, ns=1, max_depth=2)
    scene, cam = random_spheres_scene(cfg.nx, cfg.ny, device="cpu")
    view = make_view(scene, cfg)
    assert torch.equal(view.sph_tab, cs.sphere_table(view.sph_c, view.sph_r))
    assert view.sph_tab.data_ptr() % 16 == 0
    o, d = cam.generate_rays(torch.arange(cfg.num_pixels), 0, cfg.nx,
                             cfg.ny)
    args = (o, d, view.sph_c, view.sph_r)
    with_tab = cs.spheres_hit_feat(*args, view.sph_feat, cfg.epsilon,
                                   FLT_MAX, tab=view.sph_tab)
    without = cs.spheres_hit_feat(*args, view.sph_feat, cfg.epsilon, FLT_MAX)
    for a, b in zip(with_tab[:2], without[:2]):
        assert torch.equal(a, b)
    assert torch.equal(torch.stack(with_tab[2]), torch.stack(without[2]))
    assert (with_tab[1] >= 0).any()
    for a, b in zip(cs.spheres_hit_soa(*args, cfg.epsilon, FLT_MAX,
                                       tab=view.sph_tab), without[:2]):
        assert torch.equal(a, b)
    tm = torch.where(torch.arange(cfg.num_pixels) % 2 == 0, 30.0, -1.0)
    assert torch.equal(
        cs.spheres_anyhit_soa(*args, cfg.epsilon, tm, tab=view.sph_tab),
        cs.spheres_anyhit_soa(*args, cfg.epsilon, tm))


def test_prebuilt_table_is_checked():
    o, d = _rays(8, seed=29)
    c, r, feat = _spheres(6, seed=30)
    args = (_tv3(o), _tv3(d), _tv3(c), torch.from_numpy(r), T_MIN, FLT_MAX)
    tab = cs.sphere_table(*args[2:4])
    with pytest.raises(ValueError, match="shape"):
        cs.spheres_hit_soa(*args, tab=tab[:5])
    with pytest.raises(TypeError, match="float64"):
        cs.spheres_anyhit_soa(*args, tab=tab.double())
    with pytest.raises(ValueError, match="contiguous"):
        cs.spheres_hit_soa(*args, tab=torch.zeros(4, 6).t())
    misaligned = torch.zeros(6 * 4 + 1)[1:].view(6, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cs.spheres_hit_feat(*args[:4], torch.from_numpy(feat), T_MIN,
                            FLT_MAX, tab=misaligned)
    # the mx layout's table is [S, 8]
    with pytest.raises(ValueError, match="shape"):
        cs.spheres_anyhit_soa(*args, mx=True, tab=tab)


def test_other_devices_raise():
    o = V3(*(torch.zeros(4, device="meta") for _ in range(3)))
    c = V3(*(torch.zeros(2, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="meta"):
        cs.spheres_hit_soa(o, o, c, torch.ones(2, device="meta"), T_MIN,
                           FLT_MAX)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_library_name_tracks_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR
