"""The sphere kernel's plain PyTorch version against the JAX package's
Pallas kernel ``_kernel_sb`` (interpret mode), in all three modes, plus
the contract's edge cases. The CUDA kernel itself runs only on a card:
``tests/test_torch_cuda.py`` holds it against the plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops.pallas_spheres import (spheres_anyhit_soa as j_any,
                                               spheres_hit_feat as j_feat,
                                               spheres_hit_pallas as j_hit)
from tpu_pathtracer.ops.v3 import V3 as JV3
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

T_MIN = 0.01
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


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _spheres(s, seed):
    rng = np.random.RandomState(seed)
    c = rng.uniform(-10, 10, (s, 3)).astype(np.float32)
    r = rng.uniform(0.4, 2.0, s).astype(np.float32)
    feat = rng.uniform(-3, 3, (s, 18)).astype(np.float32)
    return c, r, feat


def _tv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                for k in range(3)))


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


def _case(name):
    """(origin, direction, centers, radii, feat, t_max, check) for one
    edge case of the kernel's contract."""
    if name == "tie_first_wins":
        o = np.array([[0, 0, 5], [0.1, 0, 5]], np.float32)
        d = np.array([[0, 0, -1], [0, 0, -1]], np.float32)
        c = np.array([[5, 5, 5], [0, 0, 0], [0, 0, 0], [0, 0, -3]],
                     np.float32)
        r = np.array([1.0, 1.0, 1.0, 1.0], np.float32)

        def check(t):
            assert (t[1] == 1).all()  # slots 1 and 2 tie exactly
        return o, d, c, r, None, check
    if name == "miss":
        rng = np.random.RandomState(7)
        o = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
        d = np.concatenate([np.ones((64, 1)),
                            rng.uniform(-0.2, 0.2, (64, 2))], axis=1)
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        # every ray heads to +x, every sphere lies at x < -5
        c = rng.uniform(-3, 3, (8, 3)).astype(np.float32)
        c[:, 0] -= 8.0
        r = np.full(8, 0.5, np.float32)

        def check(t):
            assert (t[1] == -1).all()
            assert (t[0] == np.float32(FLT_MAX)).all()
            assert (t[2] == 0).all()
        return o, d, c, r, None, check
    if name == "nonpositive_radius_never_wins":
        o, d = _rays(256, seed=8)
        # slots 0-5 sit 0.25 off rays 0-5 at distance 4, where a sphere
        # of radius >= 0.25 would be hit; slots 6-11 (radius 1) sit on
        # the same rays at distance 6
        side = np.cross(d[:6], np.array([0.0, 0.0, 1.0], np.float32))
        side /= np.linalg.norm(side, axis=1, keepdims=True)
        c = np.concatenate([o[:6] + 4.0 * d[:6] + 0.25 * side,
                            o[:6] + 6.0 * d[:6]]).astype(np.float32)
        r = np.array([-1.0, 0.0, -2.0, 0.0, -0.5, -0.3]
                     + [1.0] * 6, np.float32)

        def check(t):
            assert not np.isin(t[1], np.arange(6)).any()
            assert (t[1][:6] >= 6).all()  # the live sphere behind wins
        return o, d, c, r, None, check
    if name == "per_ray_tmax":
        o, d = _rays(256, seed=9)
        c, r, _ = _spheres(30, seed=10)
        t0, i0 = cs.spheres_hit_soa(_tv3(o), _tv3(d), _tv3(c),
                                    torch.from_numpy(r), T_MIN, FLT_MAX)
        hit0 = i0.numpy() >= 0
        tm = np.where(hit0, t0.numpy() * 0.5, 1e38).astype(np.float32)

        def check(t):
            # nothing before half the nearest hit; t is FLT_MAX, not t_max
            assert (t[1][hit0] == -1).all()
            assert (t[0][hit0] == np.float32(FLT_MAX)).all()
            assert hit0.sum() > 20
        return o, d, c, r, tm, check
    if name in ("ragged_s_130", "s_600_two_chunks"):
        s = 130 if name == "ragged_s_130" else 600
        o, d = _rays(256, seed=11)
        c, r, _ = _spheres(s, seed=12)
        c = c * 2.0  # spread the larger set out

        def check(t):
            assert (t[1] >= 0).sum() > 50
            if s > cs.S_CHUNK:
                assert (t[1] >= cs.S_CHUNK).any()
        return o, d, c, r, None, check
    raise KeyError(name)


@pytest.mark.parametrize("name", ["tie_first_wins", "miss",
                                  "nonpositive_radius_never_wins",
                                  "per_ray_tmax", "ragged_s_130",
                                  "s_600_two_chunks"])
def test_contract_cases(name):
    o, d, c, r, tm, check = _case(name)
    feat = np.random.RandomState(13).uniform(
        -3, 3, (c.shape[0], 18)).astype(np.float32)
    j, t, tol = _both_feat(o, d, c, r, feat, tm)
    _assert_feat_equal(j, t, tol)
    check(t)
    # the other two modes agree with the features mode
    args = (_tv3(o), _tv3(d), _tv3(c), torch.from_numpy(r), T_MIN,
            torch.from_numpy(_tmax(tm, o.shape[0])))
    t2, i2 = cs.spheres_hit_soa(*args)
    np.testing.assert_array_equal(i2.numpy(), t[1])
    np.testing.assert_array_equal(t2.numpy(), t[0])
    np.testing.assert_array_equal(cs.spheres_anyhit_soa(*args).numpy(),
                                  t[1] >= 0)


def test_cpu_tensors_take_the_plain_version():
    o, d = _rays(32, seed=14)
    c, r, feat = _spheres(8, seed=15)
    before = cs.LAUNCHES
    cs.spheres_hit_feat(_tv3(o), _tv3(d), _tv3(c), torch.from_numpy(r),
                        torch.from_numpy(feat), T_MIN, FLT_MAX)
    assert cs.LAUNCHES == before  # no kernel launched for CPU tensors


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
