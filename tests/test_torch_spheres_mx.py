"""The sphere kernel's MXU b/c layout (``mx=True``, K2 and K3): the port's
plain version against the JAX package's ``_kernel_feat`` / ``_kernel_any``
with ``mx=True`` (interpret mode) and against the port's exact form, on
the inputs of ``tests/test_fast_math.py``; and the split products against
a float64 recomputation.

Bounds. In interpret mode the JAX kernel takes the two ray x centre
products as f32 ``HIGHEST`` dots (``mx_exact=interpret``,
``pallas_spheres.py:235-240``), not as the 2-term bf16 split the port
computes (ROADMAP C-15), so the two are held to the JAX package's own mx
bounds (``tests/test_fast_math.py:55-62``): winners agree on more than
0.999 of the lanes, and where they agree the features are equal and t is
within 5e-3 relative, plus the split's own error carried through the
root (``cuda_spheres.mx_error``). That term is needed: on these inputs 18
agreeing lanes move by more than 5e-3 relative (at most 0.052, at
t = 0.0056, an absolute 3e-4), each within 0.15 of its split error; the
JAX test, whose dots are exact f32, cannot see them. The split itself is
checked exactly: every pass sum,
rounded to f32 at each addition in the stated order, equals the float64
recomputation. The CUDA kernel runs only on a card:
``tests/test_torch_cuda.py`` holds it bit for bit against this plain
version.
"""

import numpy as np
import pytest
import torch

from test_fast_math import _random_rays_spheres
from tpu_pathtracer.ops.pallas_spheres import (spheres_anyhit_soa as j_any,
                                               spheres_hit_feat as j_feat)
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops.v3 import V3
from torch_threads import one_torch_thread  # noqa: F401

T_MIN = 1e-3
AGREE = 0.999    # tests/test_fast_math.py:55
T_REL = 5e-3     # :59


def _port(o, d, c, r, feat):
    tv = lambda v: V3(*(torch.from_numpy(np.array(x)) for x in v))
    return (tv(o), tv(d), tv(c), torch.from_numpy(np.array(r)),
            torch.from_numpy(np.array(feat)))


def _assert_mx_bounds(args, ie, te, fe, im, tm, fm):
    """The JAX test's bounds between an exact-form and an mx result on the
    port's inputs ``args``, t also within the split's error."""
    assert (ie == im).mean() > AGREE
    same = (ie >= 0) & (ie == im)
    assert same.sum() > 500
    dt, _ = cs.mx_error(*args[:4], torch.from_numpy(im), T_MIN)
    tol = T_REL * np.abs(te) + dt.numpy()
    assert (np.abs(te - tm) <= tol)[same].all()
    np.testing.assert_array_equal(fe[same], fm[same])


def _feat_np(t, i, f):
    return (np.asarray(t), np.asarray(i),
            np.stack([np.asarray(x) for x in f], axis=1))


@pytest.fixture(scope="module")
def inputs():
    return _random_rays_spheres()


def test_mx_feat_matches_jax(inputs):
    o, d, c, r, feat = inputs
    jt, ji, jf = _feat_np(*j_feat(o, d, c, r, feat, T_MIN, 3.4e38,
                                  interpret=True, mx=True))
    args = _port(*inputs)
    pt, pi, pf = _feat_np(*cs.spheres_hit_feat(*args, T_MIN, 3.4e38,
                                               mx=True))
    _assert_mx_bounds(args, ji, jt, jf, pi, pt, pf)
    miss = pi < 0
    assert (pt[miss] == np.float32(3.4028235e38)).all()
    assert (pf[miss] == 0).all()


def test_mx_feat_matches_exact_form(inputs):
    args = _port(*inputs)
    te, ie, fe = _feat_np(*cs.spheres_hit_feat(*args, T_MIN, 3.4e38))
    tm, im, fm = _feat_np(*cs.spheres_hit_feat(*args, T_MIN, 3.4e38,
                                               mx=True))
    _assert_mx_bounds(args, ie, te, fe, im, tm, fm)
    # the split is not the exact form: some t moves
    assert not np.array_equal(te, tm)


def test_mx_anyhit_matches_jax_and_exact_form():
    o, d, c, r, _ = _random_rays_spheres(seed=3)
    jo = np.asarray(j_any(o, d, c, r, T_MIN, 20.0, interpret=True, mx=True))
    po, pd, pc, pr, _ = _port(o, d, c, r, np.zeros((1, 1), np.float32))
    om = cs.spheres_anyhit_soa(po, pd, pc, pr, T_MIN, 20.0, mx=True).numpy()
    oe = cs.spheres_anyhit_soa(po, pd, pc, pr, T_MIN, 20.0).numpy()
    assert (om == jo).mean() > AGREE
    assert (om == oe).mean() > AGREE
    assert 0.1 < om.mean() < 0.9


def _bf16_f64(x):
    """x (f32 numpy) rounded to bf16 to nearest even, as float64."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def test_split_products_exact():
    """``mx_products``: every part is a bf16 value, hi + lo is the operand
    to 2^-16, and each of the 3 x 3 products and the sums in the stated
    order round as a float64 recomputation rounded to f32 at each
    addition does."""
    o, d, c, r, _ = _random_rays_spheres(n=256, s=96, seed=5)
    po, pd, pc, pr, _ = _port(o, d, c, r, np.zeros((1, 1), np.float32))
    tab = cs.mx_sphere_table(pc, pr)
    cd, oc = cs.mx_products(po, pd, tab)
    t = tab.numpy().astype(np.float64)
    ch, cl = t[:, 0:3], t[:, 4:7]
    c32 = np.stack([np.asarray(x) for x in c], axis=1)
    np.testing.assert_array_equal(ch, _bf16_f64(c32))
    np.testing.assert_array_equal(cl, _bf16_f64((c32 - ch).astype(
        np.float32)))
    assert (np.abs(ch + cl - c32) <= 2.0 ** -16 * np.abs(c32)).all()
    f32 = lambda x: x.astype(np.float32).astype(np.float64)

    def pass3(a, cc):  # (a0 c0 + a1 c1) + a2 c2, f32 at each addition
        p = [a[:, k:k + 1] * cc[None, :, k] for k in range(3)]
        return f32(f32(p[0] + p[1]) + p[2])

    for v, got in ((d, cd), (o, oc)):
        a = np.stack([np.asarray(x) for x in v], axis=1)
        hi = _bf16_f64(a)
        lo = _bf16_f64((a - hi).astype(np.float32))
        want = f32(f32(pass3(hi, ch) + pass3(hi, cl)) + pass3(lo, ch))
        np.testing.assert_array_equal(got.numpy().astype(np.float64), want)
        # the products are exact: each equals its f32 rounding
        for x, y in ((hi, ch), (hi, cl), (lo, ch)):
            prod = x[:, None, :] * y[None, :, :]
            np.testing.assert_array_equal(f32(prod), prod)


def test_nonpositive_radius_never_wins():
    """A slot with radius <= 0 carries r^2 <= 0 (r^2 = -r^2 for r < 0) and
    never wins, under mx as in the exact form; the live sphere behind it
    does."""
    rng = np.random.RandomState(8)
    o = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    side = np.cross(d[:6], np.array([0.0, 0.0, 1.0]))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    c = np.concatenate([o[:6] + 4.0 * d[:6] + 0.25 * side,
                        o[:6] + 6.0 * d[:6]]).astype(np.float32)
    r = np.array([-1.0, 0.0, -2.0, 0.0, -0.5, -0.3] + [1.0] * 6, np.float32)
    tv = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                        for k in range(3)))
    feat = torch.from_numpy(rng.uniform(-3, 3, (12, 18)).astype(np.float32))
    args = (tv(o), tv(d), tv(c), torch.from_numpy(r))
    _, idx, _ = cs.spheres_hit_feat(*args, feat, T_MIN, 3.4e38, mx=True)
    idx = idx.numpy()
    assert not np.isin(idx, np.arange(6)).any()
    assert (idx[:6] >= 6).all()
    tm = torch.full((64,), 4.5)  # past the slots of radius <= 0, before
    # the live spheres (t = 5)
    occ = cs.spheres_anyhit_soa(*args, T_MIN, tm, mx=True).numpy()
    assert not occ[:6].any()


def test_cpu_tensors_take_the_plain_version(inputs):
    args = _port(*inputs)
    before = dict(cs.MX_LAUNCHES), cs.LAUNCHES
    cs.spheres_hit_feat(*args, T_MIN, 3.4e38, mx=True)
    cs.spheres_anyhit_soa(*args[:4], T_MIN, 3.4e38, mx=True)
    assert (dict(cs.MX_LAUNCHES), cs.LAUNCHES) == before
