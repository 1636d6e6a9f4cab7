"""The triangle kernel's plain PyTorch version against the JAX package's
Pallas kernel ``pallas_tris._kernel_sb`` (interpret mode), in all three
modes, on seeded random triangles and on the staircase's own triangles
with camera rays, plus the contract's edge cases. The CUDA kernel itself
runs only on a card: ``tests/test_torch_cuda.py`` holds it against the
plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.engine.wavefront import make_view as j_make_view
from tpu_pathtracer.models.mesh import procedural_staircase_scene as j_stair
from tpu_pathtracer.ops.pallas_tris import _tris_hit_impl as j_impl
from tpu_pathtracer.ops.pallas_tris import tris_anyhit_soa as j_any
from tpu_pathtracer.ops.pallas_tris import tris_hit_feat as j_feat
from tpu_pathtracer.ops.v3 import V3 as JV3
from tpu_pathtracer_torch.config import RenderConfig as TConfig
from tpu_pathtracer_torch.engine.wavefront import make_view
from tpu_pathtracer_torch.models.mesh import \
    procedural_staircase_scene as t_stair
from tpu_pathtracer_torch.ops import cuda_tris as ct
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX
from tri_cases import CASES, T_MIN
from tri_cases import case as _case
from tri_cases import prep as _prep
from tri_cases import rays as _rays
from torch_threads import one_torch_thread  # noqa: F401

# t, u, v: the JAX kernel and the plain version evaluate the same
# expressions in the same order, but XLA may contract a*b+c into an FMA
# on the CPU where PyTorch does not. a, q·e and s·n are 3-term dot
# products (q = s×d a 2-term difference each), so each may move by a few
# ulps of the magnitude of its terms: the bound on x = num/a is
# 8·2⁻²³·(Σ|terms of num|/|a| + |x|·Σ|dᵢnᵢ|/|a|) + 1e-6.
ULPS = 8 * 2.0 ** -23


def _tris(t, seed, sentinel_every=0):
    """(v0, e1, e2, n, feat) numpy: random triangles in a box, every
    ``sentinel_every``-th one an +inf sentinel as the heap pads them."""
    rng = np.random.RandomState(seed)
    v0 = rng.uniform(-8, 8, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-3, 3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-3, 3, (t, 3)).astype(np.float32)
    if sentinel_every:
        v0[::sentinel_every] = np.inf
        v1[::sentinel_every] = np.inf
        v2[::sentinel_every] = np.inf
    feat = rng.uniform(-3, 3, (t, 26)).astype(np.float32)
    return _prep(v0, v1, v2) + (feat,)


def _tv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                for k in range(3)))


def _jv3(a):
    return JV3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _tmax(t_max, n):
    return np.full(n, FLT_MAX, np.float32) if t_max is None else t_max


def _tol(o, d, tri, idx, t):
    """Per-lane bounds (|Δt|, |Δu|, |Δv|) for the winner ``idx``."""
    v0, e1, e2, n = (np.asarray(a, np.float64)[np.maximum(idx, 0)]
                     for a in tri)
    o, d = o.astype(np.float64), d.astype(np.float64)
    s = o - v0
    q = np.cross(s, d)

    a = np.maximum(np.abs(np.sum(d * n, 1)), 1e-30)
    ca = np.sum(np.abs(d * n), 1) / a
    # magnitude of each component of q = s×d before its cancellation
    qmag = np.stack([np.abs(s[:, 1] * d[:, 2]) + np.abs(s[:, 2] * d[:, 1]),
                     np.abs(s[:, 2] * d[:, 0]) + np.abs(s[:, 0] * d[:, 2]),
                     np.abs(s[:, 0] * d[:, 1]) + np.abs(s[:, 1] * d[:, 0])],
                    axis=1)
    hit = idx >= 0
    bound = lambda num_mag, x: np.where(
        hit, ULPS * (num_mag / a + ca * np.abs(x)) + 1e-6, 0.0)
    u = np.sum(q * e2, 1) / a
    v = np.sum(q * e1, 1) / a
    return (bound(np.sum(np.abs(s * n), 1), t),
            bound(np.sum(qmag * np.abs(e2), 1), u),
            bound(np.sum(qmag * np.abs(e1), 1), v))


def _both_feat(o, d, tri, feat, t_max=None):
    """((t, idx, u, v, [N, C] features) of JAX interpret mode, the same
    of the port, tolerances)."""
    tm = _tmax(t_max, o.shape[0])
    j = j_feat(_jv3(o), _jv3(d), *(_jv3(a) for a in tri), jnp.asarray(feat),
               T_MIN, jnp.asarray(tm), interpret=True)
    t = ct.tris_hit_feat(_tv3(o), _tv3(d), *(_tv3(a) for a in tri),
                         torch.from_numpy(feat), T_MIN, torch.from_numpy(tm))
    jr = tuple(np.asarray(x) for x in j[:4]) + (
        np.stack([np.asarray(x) for x in j[4]], axis=1),)
    tr = tuple(x.numpy() for x in t[:4]) + (torch.stack(t[4], 1).numpy(),)
    return jr, tr, _tol(o, d, tri, tr[1], tr[0])


def _assert_equal(j, t, tol):
    jt, ji, ju, jv, jf = j
    tt, ti, tu, tv, tf = t
    np.testing.assert_array_equal(ti, ji)              # idx exact
    assert (np.abs(tt - jt) <= tol[0]).all()
    assert (np.abs(tu - ju) <= tol[1]).all()
    assert (np.abs(tv - jv) <= tol[2]).all()
    hit = ti >= 0
    np.testing.assert_array_equal(tf[hit], jf[hit])    # features exact
    assert (tt[~hit] == np.float32(FLT_MAX)).all()
    assert (tu[~hit] == 0).all() and (tv[~hit] == 0).all()
    assert (tf[~hit] == 0).all()


def test_feat_mode_matches_pallas():
    o, d = _rays(512, seed=1)
    *tri, feat = _tris(300, seed=2, sentinel_every=11)
    j, t, tol = _both_feat(o, d, tri, feat)
    _assert_equal(j, t, tol)
    assert (t[1] >= 0).sum() > 100
    assert (t[1] >= ct.T_CHUNK).any()  # winners in the second chunk


def test_nearest_mode_matches_pallas():
    o, d = _rays(384, seed=3)
    tri = _tris(120, seed=4, sentinel_every=9)[:4]
    comps = [jnp.asarray(a[:, k]) for a in (o, d, *tri) for k in range(3)]
    jt, ji, ju, jv = (np.asarray(x) for x in
                      j_impl(*comps, T_MIN, FLT_MAX, interpret=True))
    tt, ti, tu, tv = (x.numpy() for x in ct.tris_hit_soa(
        _tv3(o), _tv3(d), *(_tv3(a) for a in tri), T_MIN, FLT_MAX))
    assert ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    tol = _tol(o, d, tri, ti, tt)
    for a, b, bound in ((tt, jt, tol[0]), (tu, ju, tol[1]),
                        (tv, jv, tol[2])):
        assert (np.abs(a - b) <= bound).all()
    assert (ti >= 0).sum() > 50


def test_anyhit_mode_matches_pallas():
    o, d = _rays(384, seed=5)
    tri = _tris(120, seed=6, sentinel_every=7)[:4]
    args = (_tv3(o), _tv3(d), *(_tv3(a) for a in tri), T_MIN)
    t_near, idx = ct.tris_hit_soa(*args, FLT_MAX)[:2]
    # per-ray t_max: past the hit on even lanes, before it on odd lanes,
    # and -1 (a lane without a shadow ray) on every 5th
    lane = np.arange(o.shape[0])
    scale = np.where(lane % 2 == 0, 1.001, 0.5)
    tm = np.where(idx.numpy() >= 0, t_near.numpy() * scale,
                  FLT_MAX).astype(np.float32)
    tm[lane % 5 == 0] = -1.0
    jo = np.asarray(j_any(_jv3(o), _jv3(d), *(_jv3(a) for a in tri), T_MIN,
                          jnp.asarray(tm), interpret=True))
    to = ct.tris_anyhit_soa(*args, torch.from_numpy(tm))
    assert to.dtype == torch.bool
    np.testing.assert_array_equal(to.numpy(), jo)
    assert not to.numpy()[lane % 5 == 0].any()
    assert 0 < to.numpy().sum() < (idx.numpy() >= 0).sum()


@pytest.fixture(scope="module")
def staircase():
    """The staircase's compacted triangles and feature table as the JAX
    engine builds them for its brute kernel, and camera rays."""
    js, jc = j_stair(48, 32)
    view = j_make_view(js, JConfig(force_feat_kernels=True))
    tri = tuple(np.stack([np.asarray(c) for c in v], axis=1)
                for v in (view.tri_v0, view.tri_e1, view.tri_e2,
                          view.tri_n))
    pix = jnp.arange(48 * 32)
    o, d = jc.generate_rays(pix, 0, 48, 32)
    o = np.stack([np.asarray(c) for c in o], axis=1)
    d = np.stack([np.asarray(c) for c in d], axis=1)
    return o, d, tri, np.asarray(view.tri_feat)


def test_staircase_camera_rays_match_pallas(staircase):
    o, d, tri, feat = staircase
    assert tri[0].shape[0] == 384 and feat.shape == (384, 26)
    j, t, tol = _both_feat(o, d, tri, feat)
    _assert_equal(j, t, tol)
    assert (t[1] >= 0).all()  # the camera sees the inside of the room


def test_staircase_shadow_rays_match_pallas(staircase):
    """Any-hit toward the staircase's light from the primary hits, with
    the light distance as t_max and -1 on every 3rd lane."""
    o, d, tri, feat = staircase
    t = ct.tris_hit_soa(_tv3(o), _tv3(d), *(_tv3(a) for a in tri), T_MIN,
                        FLT_MAX)[0].numpy()
    p = (o + d * t[:, None]).astype(np.float32)
    to_light = np.array([52.514355, 715.686951, -272.620972],
                        np.float32) - p
    dist = np.linalg.norm(to_light, axis=1)
    sd = (to_light / dist[:, None]).astype(np.float32)
    tm = (dist - 50.0).astype(np.float32)
    tm[::3] = -1.0
    jo = np.asarray(j_any(_jv3(p), _jv3(sd), *(_jv3(a) for a in tri),
                          T_MIN, jnp.asarray(tm), interpret=True))
    to = ct.tris_anyhit_soa(_tv3(p), _tv3(sd), *(_tv3(a) for a in tri),
                            T_MIN, torch.from_numpy(tm)).numpy()
    np.testing.assert_array_equal(to, jo)
    assert 0 < to.sum() < (tm > 0).sum()


@pytest.mark.parametrize("name", CASES)
def test_contract_cases(name):
    o, d, tri, tm, check = _case(name)
    tri = _prep(tri[:, 0], tri[:, 1], tri[:, 2])
    feat = np.random.RandomState(14).uniform(
        -3, 3, (tri[0].shape[0], 26)).astype(np.float32)
    j, t, tol = _both_feat(o, d, tri, feat, tm)
    _assert_equal(j, t, tol)
    check(t)
    # the other two modes agree with the features mode
    args = (_tv3(o), _tv3(d), *(_tv3(a) for a in tri), T_MIN,
            torch.from_numpy(_tmax(tm, o.shape[0])))
    for a, b in zip(ct.tris_hit_soa(*args), t[:4]):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(ct.tris_anyhit_soa(*args).numpy(),
                                  t[1] >= 0)


def test_no_rays():
    tri = _tris(10, seed=15)
    z = np.zeros((0, 3), np.float32)
    args = (_tv3(z), _tv3(z), *(_tv3(a) for a in tri[:4]), T_MIN, FLT_MAX)
    t, idx, u, v, f = ct.tris_hit_feat(*args[:6], torch.from_numpy(tri[4]),
                                       *args[6:])
    assert t.shape == idx.shape == u.shape == v.shape == (0,)
    assert len(f) == 26 and f[0].shape == (0,)
    assert ct.tris_hit_soa(*args)[1].shape == (0,)
    assert ct.tris_anyhit_soa(*args).shape == (0,)


def test_cpu_tensors_take_the_plain_version():
    o, d = _rays(32, seed=16)
    *tri, feat = _tris(8, seed=17)
    before = dict(ct.LAUNCHES)
    ct.tris_hit_feat(_tv3(o), _tv3(d), *(_tv3(a) for a in tri),
                     torch.from_numpy(feat), T_MIN, FLT_MAX)
    ct.tris_anyhit_soa(_tv3(o), _tv3(d), *(_tv3(a) for a in tri), T_MIN,
                       FLT_MAX)
    assert ct.LAUNCHES == before  # no kernel launched for CPU tensors


def test_make_view_builds_the_table_once():
    """make_view's prebuilt table is tri_table of its columns, and the
    wrappers give the same results with it as without it."""
    cfg = TConfig(nx=16, ny=12, ns=1, max_depth=2)
    scene, cam = t_stair(cfg.nx, cfg.ny, device="cpu")
    view = make_view(scene, cfg)
    cols = (view.tri_v0, view.tri_e1, view.tri_e2, view.tri_n)
    assert view.route == "brute"
    assert torch.equal(view.tri_tab, ct.tri_table(*cols))
    assert view.tri_tab.data_ptr() % 16 == 0
    o, d = cam.generate_rays(torch.arange(cfg.num_pixels), 0, cfg.nx,
                             cfg.ny)
    args = (o, d, *cols, cfg.epsilon, FLT_MAX)
    for with_tab, without in (
            (ct.tris_hit_feat(*args[:6], view.tri_feat, *args[6:],
                              tab=view.tri_tab),
             ct.tris_hit_feat(*args[:6], view.tri_feat, *args[6:])),
            (ct.tris_hit_soa(*args, tab=view.tri_tab),
             ct.tris_hit_soa(*args))):
        for a, b in zip(with_tab[:4], without[:4]):
            assert torch.equal(a, b)
        assert (with_tab[1] >= 0).all()
    tm = torch.where(torch.arange(cfg.num_pixels) % 2 == 0, 30.0, -1.0)
    assert torch.equal(ct.tris_anyhit_soa(*args[:7], tm, tab=view.tri_tab),
                       ct.tris_anyhit_soa(*args[:7], tm))


def test_prebuilt_table_is_checked():
    o, d = _rays(8, seed=29)
    tri = [_tv3(a) for a in _tris(6, seed=30)[:4]]
    args = (_tv3(o), _tv3(d), *tri, T_MIN, FLT_MAX)
    tab = ct.tri_table(*tri)
    with pytest.raises(ValueError, match="shape"):
        ct.tris_hit_soa(*args, tab=tab[:5])
    with pytest.raises(TypeError, match="float64"):
        ct.tris_anyhit_soa(*args, tab=tab.double())
    with pytest.raises(ValueError, match="contiguous"):
        ct.tris_hit_soa(*args, tab=torch.zeros(12, 6).t())


def test_other_devices_raise():
    o = V3(*(torch.zeros(4, device="meta") for _ in range(3)))
    tri = V3(*(torch.zeros(2, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="meta"):
        ct.tris_hit_soa(o, o, tri, tri, tri, tri, T_MIN, FLT_MAX)
