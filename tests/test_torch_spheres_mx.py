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
recomputation. The CUDA kernel runs only on a card, where its tensor
cores sum the nine products in their own order:
``tests/test_torch_cuda.py`` holds it against this plain version by the
bound ``cs.mx_product_bound`` carried through the roots
(``cs.mx_pair_error``). Here: the kernel's table (``cs.mx_operands``)
unpacks to the split, the bound holds for the nine products summed in
other orders and with a truncating accumulation, and the departure
checks accept a reordered sum and refuse a shifted one.
"""

import numpy as np
import pytest
import torch

from unittest import mock

import sphere_cases
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


def test_cpu_products_take_the_plain_version(inputs):
    args = _port(*inputs)
    before = cs.MX_PRODUCT_LAUNCHES
    cd, oc = cs.spheres_mx_products(*args[:4])
    want = cs.mx_products(*args[:2], cs.mx_sphere_table(*args[2:4]))
    assert torch.equal(cd, want[0]) and torch.equal(oc, want[1])
    assert cs.MX_PRODUCT_LAUNCHES == before


# the depth-16 row of the mma's A operand of one ray (csrc/spheres_mx.cu,
# item 1) from its parts: hi at depth 0-5, lo's 2nd and 3rd at 6-7, lo's
# 1st at 8
_A_ROW = ((0, 0), (0, 1), (0, 2), (0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
          (1, 0))


@pytest.mark.parametrize("s", [1, 31, 32, 33, 486])
def test_mx_operands_unpack_to_the_split(s):
    """``mx_operands``: a sphere's 8 bf16 are (ch1 ch2 ch3 cl1 cl2 cl3 ch2
    ch3) of ``split2``, its ccq the plain table's bit for bit; S pads to a
    multiple of 32 with B = 0 and ccq = +inf; and the A row times that
    column (depth 8 repeating depth 0) is the sum of the nine products."""
    rng = np.random.RandomState(60 + s)
    c = rng.uniform(-30, 30, (s, 3)).astype(np.float32)
    r = rng.uniform(-1, 2, s).astype(np.float32)
    cv, rv = sphere_cases.tv3(c), torch.from_numpy(r)
    tab = cs.mx_operands(cv, rv)
    pad = -(-s // 32) * 32
    assert tab.dtype == torch.int32 and tuple(tab.shape) == (pad, 5)
    b = tab[:, :4].contiguous().view(torch.bfloat16).float()
    hi, lo = zip(*(cs.split2(x) for x in cv))
    want = torch.stack([*hi, *lo, hi[1], hi[2]], dim=1)
    assert torch.equal(b[:s], want)
    ccq = tab[:, 4].contiguous().view(torch.float32)
    plain = cs.mx_sphere_table(cv, rv)
    assert torch.equal(ccq[:s], plain[:, 3])
    assert (b[s:] == 0).all() and torch.isinf(ccq[s:]).all()
    # the depth-16 product: B's depth 8-15 is its depth 0-7
    o, d = sphere_cases.rays(64, seed=61)
    col = torch.cat([b[:s], b[:s]], dim=1).double()  # [s, 16]
    for v in (d, o):
        parts = [cs.split2(x) for x in sphere_cases.tv3(v)]
        a = torch.zeros(64, 16, dtype=torch.float64)
        for k, (which, comp) in enumerate(_A_ROW):
            a[:, k] = parts[comp][which].double()
        got = a @ col.t()
        prods = [parts[k][0].double()[:, None] * want[:, k].double()
                 for k in range(3)]
        prods += [parts[k][0].double()[:, None] * want[:, 3 + k].double()
                  for k in range(3)]
        prods += [parts[k][1].double()[:, None] * want[:, k].double()
                  for k in range(3)]
        assert torch.equal(got, sum(prods))


def _products(o, d, c):
    """The nine products of each split product, float64 [9, N, C] for d
    and for o, and the plain table."""
    cv = sphere_cases.tv3(c)
    tab = cs.mx_sphere_table(cv, torch.ones(c.shape[0]))
    ch, cl = tab[:, 0:3].double(), tab[:, 4:7].double()
    out = []
    for v in (d, o):
        parts = [cs.split2(x) for x in sphere_cases.tv3(v)]
        hi = [p[0].double()[:, None] for p in parts]
        lo = [p[1].double()[:, None] for p in parts]
        out.append(torch.stack([hi[k] * ch[:, k] for k in range(3)]
                               + [hi[k] * cl[:, k] for k in range(3)]
                               + [lo[k] * ch[:, k] for k in range(3)]))
    return out, tab


def _truncating_sum(prods):
    """A tensor-core model: the nine exact products aligned to the largest
    one's exponent, each cut (toward 0) to 24 bits below it, summed
    exactly, the sum cut to f32 toward 0."""
    big = prods.abs().amax(dim=0)
    e = torch.floor(torch.log2(big.clamp_min(1e-300)))
    q = torch.ldexp(torch.ones_like(e), (e - 23).int())
    cut = lambda x, step: torch.trunc(x / step) * step
    total = cut(prods, q).sum(dim=0)
    f = torch.floor(torch.log2(total.abs().clamp_min(1e-300)))
    return cut(total, torch.ldexp(torch.ones_like(f), (f - 23).int()))


def _bound_sources():
    yield from ((name, sphere_cases.case(name)[:3])
                for name in sphere_cases.CASES)
    for seed in range(3):
        o, d = sphere_cases.rays(256, seed=70 + seed)
        c, _, _ = sphere_cases.spheres(96, seed=80 + seed)
        yield f"random_{seed}", (o, d, c * (1.0 + 10.0 * seed))


@pytest.mark.parametrize("name,inputs", list(_bound_sources()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_mx_product_bound_holds_for_other_orders(name, inputs):
    """``mx_product_bound``: the nine products summed in f32 in 24 seeded
    orders, in reverse, as a balanced tree, with a truncating
    accumulation, and in float64 all lie within the bound of the plain
    version's fixed order (``mx_products``), for c·d and o·c."""
    o, d, c = inputs
    (pd, po), tab = _products(o, d, c)
    ov, dv = sphere_cases.tv3(o), sphere_cases.tv3(d)
    plain = cs.mx_products(ov, dv, tab)
    bounds = cs.mx_product_bound(ov, dv, tab)
    rng = np.random.RandomState(90)
    orders = [rng.permutation(9) for _ in range(24)] + [np.arange(9)[::-1]]
    for prods, want, bound in zip((pd, po), plain, bounds):
        f32 = prods.float()  # exact: bf16 x bf16
        sums = [prods.sum(dim=0), _truncating_sum(prods)]
        for order in orders:
            acc = f32[order[0]]
            for k in order[1:]:
                acc = acc + f32[k]
            sums.append(acc.double())
        pairs = [f32[2 * k] + f32[2 * k + 1] for k in range(4)]
        sums.append((((pairs[0] + pairs[1]) + (pairs[2] + pairs[3]))
                     + f32[8]).double())
        for got in sums:
            gap = (got - want.double()).abs()
            assert (gap <= bound).all(), (name, (gap / bound).max())
        # the bound is not slack by orders of magnitude
        assert (bound <= cs.MX_ULPS * 2.0 ** -24 * prods.abs().sum(0)
                * (1 + 1e-12)).all()


def _reordered_products(origin, direction, tab, lanes=False):
    """``mx_products`` with each c·d and o·c summed lo·hi pass first, each
    pass backwards: another order, as a tensor core may take."""
    def p(a, cc):
        return (a[2] * cc[:, 2] + a[1] * cc[:, 1]) + a[0] * cc[:, 0]
    return cs._mx_passes(origin, direction, tab, lanes,
                         lambda hi, lo, ch, cl: p(lo, ch) + p(hi, cl)
                         + p(hi, ch))


_PLAIN_PRODUCTS = cs.mx_products


def _shifted_products(origin, direction, tab, lanes=False):
    """``mx_products`` with o·c moved by 0.05 of |o·c| + 1: far past the
    bound."""
    cd, oc = _PLAIN_PRODUCTS(origin, direction, tab, lanes)
    return cd, oc + 0.05 * (oc.abs() + 1.0)


def test_departure_checks_accept_reordered_and_refuse_shifted(inputs):
    """The card's checks of K2/K3 against the plain version
    (``mx_nearest_departures``, ``mx_anyhit_departures``) on the plain
    version run with another summation order: every departure is
    explained; with products shifted past the bound, they raise."""
    o, d, c, r, feat = _port(*inputs)
    n = o.x.shape[0]
    tm = torch.full((n,), 3.4e38)
    plain = cs._spheres_hit_feat_ref(o, d, c, r, feat, T_MIN, tm, mx=True)
    t_any = torch.where(plain[1] >= 0, plain[0] * 1.001, 3.4e38)
    t_any[1::2] = torch.where(plain[1][1::2] >= 0, plain[0][1::2] * 0.5,
                              3.4e38)
    occ_p = cs._spheres_anyhit_ref(o, d, c, r, T_MIN, t_any, mx=True)
    for fn, ok in ((_reordered_products, True), (_shifted_products, False)):
        with mock.patch.object(cs, "mx_products", fn):
            kern = cs._spheres_hit_feat_ref(o, d, c, r, feat, T_MIN, tm,
                                            mx=True)
            occ_k = cs._spheres_anyhit_ref(o, d, c, r, T_MIN, t_any,
                                           mx=True)
        if ok:
            got = cs.mx_nearest_departures(o, d, c, r, T_MIN, tm, kern,
                                           plain)
            assert got["hits"] > 500 and got["lanes"] == n
            assert got["t_err"] <= got["t_bound"]
            cs.mx_anyhit_departures(o, d, c, r, T_MIN, t_any, occ_k, occ_p)
        else:
            with pytest.raises(AssertionError):
                cs.mx_nearest_departures(o, d, c, r, T_MIN, tm, kern, plain)
            assert not torch.equal(occ_k, occ_p)
            with pytest.raises(AssertionError):
                cs.mx_anyhit_departures(o, d, c, r, T_MIN, t_any, occ_k,
                                        occ_p)


def test_tile_constants_match_the_kernel_source():
    """``MX_RAYS`` and ``MX_CHUNK`` (the mx table's padding, and the tiling
    ``chip_smoke.py``'s issue-rate floor counts steps by) are
    ``csrc/spheres_mx.cu``'s ``kRays`` and ``kChunk``."""
    import re
    from tpu_pathtracer_torch.ops import _build
    text = (_build.CSRC_DIR / "spheres_mx.cu").read_text()
    const = lambda k: int(re.search(rf"constexpr int {k} = (\d+);",
                                    text).group(1))
    assert (cs.MX_RAYS, cs.MX_CHUNK) == (const("kRays"), const("kChunk"))


def _fake_sass(step_extra, slot_fast, slots=8, hmma=4):
    """A ``cuobjdump -sass`` listing of the sphere loop's shape
    (``csrc/spheres_mx.cu``): per mode a kernel whose loop holds ``hmma``
    HMMA, ``step_extra`` more instructions before the roots' branch, and
    ``slots`` slots of ``slot_fast`` instructions on the sqrtf's fast path
    and 5 on its slow one. Returns the text and what ``step_sass`` should
    read."""
    out = []
    for arg in (1, 2, 3):
        code, labels = [], {}

        def ins(text, label=None):
            if label:
                labels[label] = len(code)
            code.append(text)

        ins("MOV R1, c[0x0][0x28]")
        ins("LDSM.16.M88.4 R16, [R12]", "head")
        for _ in range(hmma):
            ins("HMMA.16816.F32.BF16 R28, R8, R16, RZ")
        for _ in range(step_extra):
            ins("FADD R45, R4, -R30")
        ins("@P1 BRA P5, {end}")
        for k in range(slots):
            ins("FSETP.GT.AND P1, PT, R12, RZ, PT")
            ins(f"BSSY B1, {{s{k}}}")
            ins(f"@!P1 BRA {{s{k}}}")
            ins("MUFU.RSQ R25, R12")
            ins(f"@!P1 BRA {{f{k}}}")
            for _ in range(4):
                ins("MOV R31, 0x0")
            ins(f"BRA {{j{k}}}")
            for n in range(slot_fast - 3):
                ins("FMUL.FTZ R13, R12, R25", f"f{k}" if n == 0 else None)
            ins("FADD R25, -R28, -R13", f"j{k}")
            ins("BSYNC B1", f"s{k}")
        ins("BSYNC B0", "end")
        ins("VIADD R39, R39, 0x20")
        ins("@!P1 BRA {head}")
        ins("EXIT")
        addr = {k: f"0x{16 * v:x}" for k, v in labels.items()}
        out.append(f"\t\tFunction : _ZN_17spheres_mx_kernelILi{arg}EEEvPKf")
        out += [f"        /*{16 * a:04x}*/   {c.format(**addr)} ;"
                f"   /* 0x000000000000000 */" for a, c in enumerate(code)]
    return "\n".join(out), (hmma + step_extra + 5, 4 * slots,
                            float(slot_fast))


@pytest.mark.parametrize("step_extra,slot_fast", [(60, 17), (71, 16)])
def test_step_sass_counts_the_sphere_loop(step_extra, slot_fast):
    """``spheres_mx_ab.step_sass``, which ``chip_smoke.py``'s issue-rate
    floor reads from the build: a step without the roots' branch, the
    branch's own instructions and a slot's fast path, in the features and
    any-hit kernels (not the products mode's)."""
    from tpu_pathtracer_torch.experiments import common
    from tpu_pathtracer_torch.experiments import spheres_mx_ab as ab
    text, want = _fake_sass(step_extra, slot_fast)
    assert ab.step_sass(text) == {"features": want, "any_hit": want}
    counts = common.sass_counts(text)
    assert sorted(c[1:] for c in counts.values()) == [(4, 1)] * 3


@pytest.mark.parametrize("bad", [dict(hmma=0), dict(slots=2)])
def test_step_sass_refuses_another_loop(bad):
    """A build without HMMA, or whose roots' branch is not 8 slots, is not
    counted: ``step_sass`` raises rather than price another loop."""
    from tpu_pathtracer_torch.experiments import spheres_mx_ab as ab
    with pytest.raises(ValueError):
        ab.step_sass(_fake_sass(60, 17, **bad)[0])
