"""The sphere layout probe of the port
(``tpu_pathtracer_torch/experiments/sphere_layout_probe.py``, K25a ``sb``
and K25b ``sbf``): its inputs against the TPU file's
(``experiments/sphere_layout_probe.py``, ``main``), its plain versions
against ``_kernel_sb`` and ``_kernel_sbf`` in interpret mode and against
the port's K1 plain version, and finding C-20 on a crafted feature table.

The TPU file is imported by its path into a private copy whose ``S`` is
set to 32: ``_kernel_sbf`` contracts over all S slots, and at the file's
S = 512 one interpret-mode call of its 512 unrolled slots takes minutes.
The copy's table holds the headline's ground, its first 26 small spheres
and its three large ones, and two pad slots; the rays are the file's draw
order at 2048 rays. Both kernels run in one interpret-mode
``pallas_call`` (one trace), ``sbf`` on a 36-row feature table: the file's
18 features, then the same 18 with two crafted values (C-20).

Tolerances. idx and the features are exact. t: XLA contracts the
oc-form's multiply-adds into FMAs on the CPU (ROADMAP C-2), where the
port's plain version, like the CUDA kernel built with -fmad=false, does
not; JAX's t is then bit-equal to the same slot loop with XLA's
contractions (b, c and disc), which the test restates in numpy. t against
the port is held at the sphere tests' bound (``test_torch_spheres.py``:
rtol 1e-5 plus the grazing term). The CUDA kernels run only on a card:
``tests/test_torch_cuda.py`` holds them bit for bit against these plain
versions and K1.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_pathtracer.models.spheres import random_spheres_scene as j_scene
from tpu_pathtracer_torch.experiments import sphere_layout_probe as sl
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops.v3 import V3

EXP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "experiments")
S_TEST = 32
N_RAYS = 2048
T_RTOL = 1e-5   # test_torch_spheres.py's bound on XLA's FMA contraction
F32 = np.float32


@pytest.fixture(scope="module")
def jsl():
    spec = importlib.util.spec_from_file_location(
        "sphere_layout_probe", os.path.join(EXP, "sphere_layout_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.S = S_TEST
    return mod


@pytest.fixture(scope="module")
def jscene():
    scene, _ = j_scene(1200, 800)
    return np.asarray(scene.sphere_center), np.asarray(scene.sphere_radius)


def _file_table(sc, sr, s):
    """The TPU file's table (:186-190) and its padded feature table
    (:200-201, :245-248), in numpy."""
    ns = sc.shape[0]
    cx = jnp.zeros((4, s), jnp.float32)
    cx = cx.at[0, :ns].set(sc[:, 0]).at[1, :ns].set(sc[:, 1]) \
        .at[2, :ns].set(sc[:, 2]) \
        .at[3, :ns].set(sr * sr * jnp.where(sr > 0, 1.0, -1.0)) \
        .at[3, ns:].set(-1.0)
    feat = jnp.concatenate([sc, sr[:, None],
                            jnp.ones((ns, 14), jnp.float32)], axis=1)
    feat_tt = jnp.concatenate(
        [feat.T, jnp.zeros((feat.shape[1], s - ns), jnp.float32)], axis=1)
    return np.asarray(cx), np.asarray(feat), np.asarray(feat_tt)


def _file_rays(m):
    """The TPU file's rays (:192-197)."""
    rng = np.random.RandomState(0)
    o = rng.uniform(-8, 8, (3, m)).astype(np.float32)
    o[1] += 10
    d = rng.randn(3, m).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def test_probe_inputs_are_the_tpu_files(jscene):
    inp = sl.probe_inputs("cpu")
    o, d = _file_rays(sl.M)
    cx, feat, feat_tt = _file_table(*jscene, sl.S)
    rays = inp["rays"].numpy()
    np.testing.assert_array_equal(rays[:3], o)
    np.testing.assert_array_equal(rays[3:6], d)
    assert (rays[6] == np.finfo(F32).max).all()
    for key, want in (("sph", cx), ("feat", feat), ("feat_t", feat_tt)):
        np.testing.assert_array_equal(inp[key].numpy(), want)
    assert feat.shape == (486, sl.N_C)


@pytest.fixture(scope="module")
def small(jscene):
    """The port's inputs at S = 32 (30 spheres, 2 pads) and 2048 rays;
    ``feat_t`` [36, 32]: the 18 features, then the same with inf at
    (feature 0, slot 5) and 3.4e38 (whose bf16 rounding is inf) at
    (feature 1, slot 7)."""
    sc, sr = jscene
    pick = np.r_[0:27, len(sr) - 3:len(sr)]
    c, r = torch.from_numpy(sc[pick]), torch.from_numpy(sr[pick])
    feat_t = sl.feature_table(sl.feature_rows(c, r), S_TEST)
    crafted = feat_t.clone()
    crafted[0, 5] = float("inf")
    crafted[1, 7] = 3.4e38
    o, d = _file_rays(N_RAYS)
    tmax = np.full((1, N_RAYS), np.finfo(F32).max, F32)
    return {"rays": torch.from_numpy(np.concatenate([o, d, tmax])),
            "sph": sl.sphere_table(c, r, S_TEST), "feat_t": feat_t,
            "crafted": crafted, "file": _file_table(sc[pick], sr[pick],
                                                    S_TEST)}


def test_small_table_is_the_files_encoding(small):
    cx, _, feat_tt = small["file"]
    np.testing.assert_array_equal(small["sph"].numpy(), cx)
    np.testing.assert_array_equal(small["feat_t"].numpy(), feat_tt)


@pytest.fixture(scope="module")
def jax_out(jsl, small):
    """(t_sb, i_sb, t_sbf, i_sbf, f [36, n]) of ``_kernel_sb`` and
    ``_kernel_sbf`` in one interpret-mode call with ``run_sb``'s and
    ``run_sbf``'s specs (the table's HBM space as ``pl.ANY``)."""
    n, n_c = N_RAYS, 2 * sl.N_C
    shp2 = (n // 128, 128)
    ray = pl.BlockSpec((sl.ROWS, 128), lambda i: (i, 0))
    anyspace = pl.BlockSpec(memory_space=pl.ANY)
    ftab = pl.BlockSpec((n_c, S_TEST), lambda i: (0, 0))
    fspec = pl.BlockSpec((n_c, sl.ROWS * 128), lambda i: (0, i))

    def both(*refs):
        jsl._kernel_sb(*refs[:8], *refs[9:11], t_min=sl.T_MIN, n_s=S_TEST)
        jsl._kernel_sbf(*refs[:9], *refs[11:], t_min=sl.T_MIN, n_s=S_TEST,
                        n_c=n_c)

    f32, i32 = jnp.float32, jnp.int32
    feat_t = torch.cat([small["feat_t"], small["crafted"]])
    out = pl.pallas_call(
        both, grid=(n // (sl.ROWS * 128),),
        in_specs=[ray] * 7 + [anyspace, ftab],
        out_specs=(ray, ray, ray, ray, fspec),
        out_shape=(jax.ShapeDtypeStruct(shp2, f32),
                   jax.ShapeDtypeStruct(shp2, i32),
                   jax.ShapeDtypeStruct(shp2, f32),
                   jax.ShapeDtypeStruct(shp2, i32),
                   jax.ShapeDtypeStruct((n_c, n), f32)),
        interpret=True)(
            *(jnp.asarray(a.reshape(shp2)) for a in small["rays"].numpy()),
            jnp.asarray(small["sph"].numpy()), jnp.asarray(feat_t.numpy()))
    return [np.asarray(a).reshape(-1) for a in out[:4]] + [np.asarray(out[4])]


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F32)


def _contracted(rays, tab, t_min):
    """The slot loop with XLA's contractions: b = fma(ocz, dz, fma(ocx,
    dx, ocy dy)), c = fma(ocz, ocz, fma(ocx, ocx, ocy ocy)) - r2, disc =
    fma(b, b, -c); every fma one rounding of the exact value (the float64
    sum of a float32 product and a float32 is exact here but for rare
    double roundings)."""
    o1, o2, o3, d1, d2, d3, t_best = rays
    i_best = np.full(o1.shape, -1, np.int32)
    t_min = F32(t_min)
    for s in range(tab.shape[1]):
        ocx, ocy, ocz = o1 - tab[0, s], o2 - tab[1, s], o3 - tab[2, s]
        b = _fma(ocz, d3, _fma(ocx, d1, ocy * d2))
        c = _fma(ocz, ocz, _fma(ocx, ocx, ocy * ocy)) - tab[3, s]
        disc = _fma(b, b, -c)
        sq = np.sqrt(np.maximum(disc, F32(0)))
        t1, t2 = -b - sq, -b + sq
        ts0 = np.where(t1 > t_min, t1, t2)
        win = (disc > 0) & (ts0 > t_min) & (ts0 < t_best)
        t_best = np.where(win, ts0, t_best)
        i_best = np.where(win, s, i_best)
    return np.where(i_best >= 0, t_best, np.finfo(F32).max)


def _t_tol(rays, tab, idx, t):
    """test_torch_spheres.py's per-lane bound for the winner ``idx``:
    T_RTOL |t| plus 4 ulp of b² carried through sqrt(disc)."""
    o, d = rays[:3].T.astype(np.float64), rays[3:6].T
    w = tab[:, np.maximum(idx, 0)].T.astype(np.float64)
    oc = o - w[:, :3]
    b = np.sum(oc * d, axis=1)
    disc = b * b - (np.sum(oc * oc, axis=1) - w[:, 3])
    graze = 4 * 2.0 ** -23 * b * b / np.sqrt(np.maximum(disc, 1e-30))
    return np.where(idx >= 0, T_RTOL * np.abs(t) + graze, 0.0)


@pytest.mark.parametrize("kernel", ["sb", "sbf"])
def test_plain_matches_jax_kernel(small, jax_out, kernel):
    """idx exact, JAX's t the contracted slot loop bit for bit (or, where
    XLA contracts nothing, the port's), t within the C-2 bound."""
    rays, tab = small["rays"].numpy(), small["sph"].numpy()
    tj, ij = jax_out[:2] if kernel == "sb" else jax_out[2:4]
    if kernel == "sb":
        tp, ip = (a.numpy() for a in sl.sb_plain(small["rays"], small["sph"],
                                                 n_s=S_TEST))
    else:
        tp, ip, _ = (a.numpy() for a in sl.sbf_plain(
            small["rays"], small["sph"], small["feat_t"]))
    np.testing.assert_array_equal(ip, ij)
    hits = np.bincount(ip + 1, minlength=S_TEST + 1)
    assert 0 < hits[0] < N_RAYS and (hits[1:] > 0).sum() >= 5
    assert (tj[ij < 0] == np.finfo(F32).max).all()
    assert np.array_equal(tj, _contracted(rays, tab, sl.T_MIN)) \
        or np.array_equal(tj, tp)
    np.testing.assert_array_less(np.abs(tp.astype(np.float64) - tj),
                                 _t_tol(rays, tab, ip, tj) + 1e-300)


def test_sbf_features_match_jax_kernel(small, jax_out):
    """The fetched features equal JAX's on every lane and are the table's
    column (0 on a miss)."""
    _, ip, fp = sl.sbf_plain(small["rays"], small["sph"], small["feat_t"])
    fj = jax_out[4][:sl.N_C]
    np.testing.assert_array_equal(fp.numpy(), fj)
    ip = ip.numpy()
    want = small["feat_t"].numpy()[:, np.maximum(ip, 0)] * (ip >= 0)
    np.testing.assert_array_equal(fj, want)


def test_c20_jax_nans_a_column_and_the_port_refuses(small, jax_out):
    """C-20: one non-finite slot (inf; 3.4e38, inf in bf16) turns its
    feature into NaN for every ray under the TPU's one-hot product; the
    other features stay exact. The port refuses the table."""
    fj = jax_out[4][sl.N_C:]
    assert np.isnan(fj[:2]).all()
    ip = jax_out[3]
    np.testing.assert_array_equal(
        fj[2:], small["feat_t"].numpy()[2:, np.maximum(ip, 0)] * (ip >= 0))
    for bad in (0, 1):
        table = small["feat_t"].clone()
        table[bad] = small["crafted"][bad]
        with pytest.raises(ValueError, match="C-20"):
            sl.check_features(table)
        with pytest.raises(ValueError, match="C-20"):
            sl.spheres_sbf(small["rays"], small["sph"], table)
    sl.check_features(small["feat_t"])
    assert np.isfinite(fj[2:]).all()


def test_plain_is_k1_on_the_full_table():
    """On the file's 512-slot table the plain versions give K1's plain
    version's t and idx bit for bit (the pads never win), and K1's
    features."""
    inp = sl.probe_inputs("cpu", m=1024)
    rays = inp["rays"]
    t, idx, f = sl.sbf_plain(rays, inp["sph"], inp["feat_t"])
    tk, ik, fk = cs._spheres_hit_feat_ref(
        V3(*rays[:3]), V3(*rays[3:6]), V3(*inp["centers"].t()), inp["radii"],
        inp["feat"], sl.T_MIN, rays[6])
    assert torch.equal(t, tk) and torch.equal(idx, ik)
    assert torch.equal(f, torch.stack(fk))
    ts, i_s = sl.spheres_sb(rays, inp["sph"])
    assert torch.equal(ts, t) and torch.equal(i_s, idx)
    assert 0 < int((idx >= 0).sum()) < idx.numel()


def test_sb_walks_the_first_n_s_slots():
    """n_s below S: slots past n_s never win (the ground, slot 0, still
    does)."""
    inp = sl.probe_inputs("cpu", m=1024)
    t, idx = sl.spheres_sb(inp["rays"], inp["sph"], n_s=1)
    assert set(idx.unique().tolist()) <= {-1, 0}
    t0, i0 = sl.sb_plain(inp["rays"], inp["sph"][:, :1], n_s=1)
    assert torch.equal(t, t0) and torch.equal(idx, i0)


def test_sbf_needs_every_slot(small):
    with pytest.raises(ValueError, match="slots"):
        sl.spheres_sbf(small["rays"], small["sph"],
                       small["feat_t"][:, :S_TEST - 1].contiguous())
