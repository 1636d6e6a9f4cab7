"""Brute-force nearest / any ray–sphere hit: the CUDA kernel
``csrc/spheres.cu`` and its plain PyTorch version (counterpart of
``tpu_pathtracer/ops/pallas_spheres.py``).

The public functions dispatch on the device of their inputs: tensors on
the CPU go to the plain version, tensors on a CUDA device to the kernel
(or the call raises). There is no fallback from one to the other.

Contract of all three modes: the oc-form quadratic with a unit
direction; the near root if it is > t_min, else the far root; a sphere
wins if disc > 0 and t_min < t < t_best, with t_best starting at the
ray's t_max, tested in slot order with a strict <, so the first sphere
wins a tie. A sphere with radius <= 0 carries r² = −r² in the table and
never wins. On a miss t = FLT_MAX, idx = −1 and the features are 0.

``mx=True`` (``spheres_hit_feat`` and ``spheres_anyhit_soa``) is the JAX
package's MXU b/c layout, ``_kernel_feat`` / ``_kernel_any`` with
``mx=True``: the kernel ``csrc/spheres_mx.cu`` and its plain version
here. It takes b and c from the expanded form, b = o·d − c·d and
c = (|o|² − 2·o·c) + (|c|² − r²·sign), with the two ray × centre products
from a 2-term bf16 split of each operand summed in three passes (see
``mx_products``); the roots, the validity test and the winner rules are
the ones above. The expanded |oc|² cancels for origins near a sphere, so
its winners depart from the exact form's on grazing and self-epsilon
lanes: it is a measured decision record, on no render path. The kernel
sums the nine products on the tensor cores, in their order and rounding:
it is held to the plain version by a bound (``mx_product_bound``,
``mx_pair_error``, ``mx_nearest_departures``, ``mx_anyhit_departures``),
not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

# Kernel launches by the wrappers below, all modes together. Callers
# reset it to 0 and read it back to show that a run went through the
# kernel.
LAUNCHES = 0
# Launches of the mx kernel (csrc/spheres_mx.cu), per mode.
MX_LAUNCHES = {"features": 0, "any_hit": 0}
# Launches of its products mode (``spheres_mx_products``), a check's.
MX_PRODUCT_LAUNCHES = 0

_NEAREST, _FEATURES, _ANY_HIT = 0, 1, 2  # csrc/spheres.cu Mode
# csrc/spheres_mx.cu Mode (it has no t/idx-only mode: the JAX package's
# spheres_hit_soa takes no mx; _MX_PRODUCTS writes c·d and o·c)
_MX_PRODUCTS = 3
_MX_MODE_NAMES = {_FEATURES: "features", _ANY_HIT: "any_hit"}
S_CHUNK = 512  # spheres per pass of the plain version (bounds [N, chunk])
MX_CHUNK = 32  # csrc/spheres_mx.cu kChunk: the mx table's rows pad to it
MX_RAYS = 8  # csrc/spheres_mx.cu kRays: the rays of a warp's tile
# The bound on each of the kernel's split products against the plain
# version's: MX_ULPS × 2⁻²⁴ × the sum of the magnitudes of its nine
# products. The plain order rounds 8 times to nearest (each within 2⁻²⁴
# of a partial sum, which is at most that sum) and the tensor core adds
# the nine in its own order and rounding, which may truncate.
MX_ULPS = 32
_U = 2.0 ** -24


def sphere_table(centers: V3, radii: torch.Tensor) -> torch.Tensor:
    """[S, 4] float32 rows (cx, cy, cz, r²·sign(r)): a slot with radius
    <= 0 gets r² <= 0, so disc < 0 by Cauchy–Schwarz and it never wins.
    A fresh allocation, so 16-byte aligned. A caller that launches the
    kernel many times on one scene builds it once and passes it as
    ``tab`` (``engine.wavefront.make_view``)."""
    r2 = radii * radii * torch.where(radii > 0, 1.0, -1.0)
    return torch.stack([centers.x, centers.y, centers.z, r2], dim=1)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split2(x: torch.Tensor):
    """The 2-term bf16 split of ``x`` (``pallas_spheres._bc_mxu``): hi =
    bf16(x), lo = bf16(x − hi), as f32. hi + lo is x to 2⁻¹⁶ relative."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def mx_sphere_table(centers: V3, radii: torch.Tensor) -> torch.Tensor:
    """[S, 8] float32 rows of the mx kernel: the centre's hi parts, then
    |c|² − r²·sign(r), then its lo parts, then 0 (cxh, cyh, czh, ccq,
    cxl, cyl, czl, 0: two float4 a sphere)."""
    tab = sphere_table(centers, radii)
    hi, lo = split2(tab[:, :3])
    cx, cy, cz, r2 = tab.unbind(1)
    ccq = cx * cx + cy * cy + cz * cz - r2
    return torch.cat([hi, ccq[:, None], lo, torch.zeros_like(ccq)[:, None]],
                     dim=1)


def mx_operands(centers: V3, radii: torch.Tensor) -> torch.Tensor:
    """[S_pad, 5] int32 rows of the mx kernel (csrc/spheres_mx.cu), S_pad =
    S rounded up to ``MX_CHUNK``: a sphere's column of the mma's B operand,
    (ch1 ch2 ch3 cl1 cl2 cl3 ch2 ch3) as 8 bf16 in 4 words (the first in
    the low half of the first word), then the bits of its f32 ccq =
    |c|² − r²·sign(r), both from :func:`mx_sphere_table`. The padding
    slots have B = 0 and ccq = +inf: c = +inf, never valid."""
    tab = mx_sphere_table(centers, radii)
    s = tab.shape[0]
    s_pad = -(-s // MX_CHUNK) * MX_CHUNK
    ch, cl = tab[:, 0:3], tab[:, 4:7]
    col = torch.cat([ch, cl, ch[:, 1:3]], dim=1).to(torch.bfloat16)
    ccq = torch.full((s_pad,), float("inf"), dtype=torch.float32,
                     device=tab.device)
    ccq[:s] = tab[:, 3]
    out = torch.zeros((s_pad, 5), dtype=torch.int32, device=tab.device)
    out[:s, :4] = col.contiguous().view(torch.int32)
    out[:, 4] = ccq.view(torch.int32)
    return out


def _tmax_vector(t_max, n: int, like: torch.Tensor) -> torch.Tensor:
    if isinstance(t_max, torch.Tensor):
        return t_max.to(like.dtype).expand(n).contiguous()
    return torch.full((n,), float(t_max), dtype=like.dtype,
                      device=like.device)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _sphere_ts(origin: V3, direction: V3, tab: torch.Tensor, t_min: float,
               tmax: torch.Tensor) -> torch.Tensor:
    """[N, C] candidate t of each ray against each sphere of the chunk
    ``tab`` [C, 4], FLT_MAX where the sphere cannot win. Each expression
    has the kernel's operation order, so the two round alike."""
    ocx = origin.x[:, None] - tab[:, 0]
    ocy = origin.y[:, None] - tab[:, 1]
    ocz = origin.z[:, None] - tab[:, 2]
    b = ocx * direction.x[:, None] + ocy * direction.y[:, None] \
        + ocz * direction.z[:, None]
    c = ocx * ocx + ocy * ocy + ocz * ocz - tab[:, 3]
    return _root_ts(b, c, t_min, tmax)


def _root_ts(b, c, t_min, tmax):
    """The near root if it is > t_min, else the far one, where it is
    valid (disc > 0, t_min < t < t_max), else FLT_MAX."""
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    ts0 = torch.where(t1 > t_min, t1, t2)
    valid = (disc > 0.0) & (ts0 > t_min) & (ts0 < tmax[:, None])
    return torch.where(valid, ts0, FLT_MAX)


def _ray(x: torch.Tensor, lanes: bool) -> torch.Tensor:
    """A ray quantity against a chunk's columns ([N, 1]) or, ``lanes``,
    against one sphere a lane ([N])."""
    return x if lanes else x[:, None]


def _mx_passes(origin: V3, direction: V3, tab: torch.Tensor, lanes: bool,
               fn):
    """``fn(hi, lo, ch, cl)`` for the ray parts of d and of o (each a
    tuple of 3 from ``split2``, shaped by :func:`_ray`) against the
    centre parts of ``tab``."""
    ch, cl = tab[:, 0:3], tab[:, 4:7]
    out = []
    for v in (direction, origin):
        hi, lo = zip(*(split2(comp) for comp in v))
        out.append(fn(tuple(_ray(x, lanes) for x in hi),
                      tuple(_ray(x, lanes) for x in lo), ch, cl))
    return out


def mx_products(origin: V3, direction: V3, tab: torch.Tensor,
                lanes: bool = False):
    """(cd, oc), each [N, C]: d·c and o·c of each ray against the centres
    of the mx table chunk ``tab`` [C, 8], as ``pallas_spheres._bc_mxu``
    takes them on the matrix unit: each operand split into bf16 hi and lo
    (``split2``), and three passes, P(hi, hi) + P(hi, lo), then + P(lo, hi)
    (ray part first; lo·lo is dropped), each pass
    P(x, y) = (x0·y0 + x1·y1) + x2·y2. A product of two bf16 values is
    exact in f32, so this order fixes every rounding. ``lanes``: ``tab``
    is [N, 8], one sphere a lane, and each is [N]."""
    def p(a, cc):
        return (a[0] * cc[:, 0] + a[1] * cc[:, 1]) + a[2] * cc[:, 2]

    return _mx_passes(origin, direction, tab, lanes,
                      lambda hi, lo, ch, cl: p(hi, ch) + p(hi, cl)
                      + p(lo, ch))


def mx_product_bound(origin: V3, direction: V3, tab: torch.Tensor,
                     lanes: bool = False):
    """(e_cd, e_oc), float64 and shaped as :func:`mx_products`: how far
    the kernel's c·d and o·c may each lie from the plain version's,
    ``MX_ULPS`` × 2⁻²⁴ × the sum of the magnitudes of its nine products."""
    f64 = torch.float64

    def mag(a, cc):
        return sum(a[k].to(f64).abs() * cc[:, k].to(f64).abs()
                   for k in range(3))

    return [MX_ULPS * _U * s for s in _mx_passes(
        origin, direction, tab, lanes,
        lambda hi, lo, ch, cl: mag(hi, ch) + mag(hi, cl) + mag(lo, ch))]


def mx_pair_error(origin: V3, direction: V3, tab: torch.Tensor,
                  t_min: float, tmax: torch.Tensor, lanes: bool = False):
    """The plain version's outcome of each (ray, sphere) pair and the
    kernel's bound around it: (ts0, valid, dt, flip), shaped as
    :func:`mx_products` (``tmax`` [N]). ts0 and valid are the plain
    version's candidate t and validity (``_mx_sphere_ts``); the kernel's
    c·d and o·c lie within :func:`mx_product_bound` of the plain ones, and
    float64 carries that, with each f32 rounding of both forms (2⁻²⁴ of
    the plain value and of the bound, doubled), through b = o·d − c·d,
    c = (|o|² − 2·o·c) + ccq, disc = b·b − c, √disc and the roots: dt
    bounds the distance of the kernel's candidate t from ts0, and flip
    marks a pair whose validity or root the bound can change (disc within
    its error of 0, or the near root, ts0 within dt of t_min, or ts0
    within dt of t_max). dt is +inf where disc is not clear of 0."""
    f64 = torch.float64
    o1, o2, o3 = origin
    d1, d2, d3 = direction
    od = _ray(d1 * o1 + d2 * o2 + d3 * o3, lanes)
    oo = _ray(o1 * o1 + o2 * o2 + o3 * o3, lanes)
    cd, oc = mx_products(origin, direction, tab, lanes)
    e_cd, e_oc = mx_product_bound(origin, direction, tab, lanes)
    ccq = tab[:, 3]
    b = od - cd
    x = oo - 2.0 * oc
    c = x + ccq
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = -b - sq
    ts0 = torch.where(t1 > t_min, t1, -b + sq)
    tm = _ray(tmax, lanes)
    valid = (disc > 0.0) & (ts0 > t_min) & (ts0 < tm)

    a = lambda v: v.to(f64).abs()
    r = 1.0 + 4.0 * _U  # a rounding of each form, and margin
    db = e_cd * r + 4.0 * _U * a(b)
    dx = 2.0 * e_oc * r + 4.0 * _U * a(x)
    dc = dx * r + 4.0 * _U * a(c)
    dbb = db * (2.0 * a(b) + db) * r + 4.0 * _U * a(b) ** 2
    dd = (dbb + dc) * r + 4.0 * _U * a(disc)
    sq64 = sq.to(f64)
    dsq = dd / sq64.clamp_min(1e-300) * r + 4.0 * _U * sq64
    dt = (db + dsq) * r + 4.0 * _U * (a(b) + sq64)
    live = disc.to(f64) > dd
    near = lambda v, w: (v.to(f64) - w).abs() <= dt
    flip = (a(disc) <= dd) | (live & (near(t1, t_min) | near(ts0, t_min)
                                      | near(ts0, tm.to(f64))))
    return ts0, valid, torch.where(live, dt, torch.inf), flip


def _lane_rows(centers: V3, radii: torch.Tensor, idx: torch.Tensor):
    """The mx table's row of sphere ``idx`` (clamped at 0) for each lane."""
    return mx_sphere_table(centers, radii)[idx.clamp_min(0).long()]


def mx_nearest_departures(origin: V3, direction: V3, centers: V3,
                          radii: torch.Tensor, t_min: float, t_max, kern,
                          plain) -> dict:
    """Hold the kernel's nearest hits ``kern`` = (t, idx, features) to the
    plain version's ``plain`` on the same rays, by the bound: where the
    winners agree, t lies within the pair's dt (or its root may flip) and
    the features are equal; each lane whose winner differs is one the
    bound can flip (the plain or the kernel's winner's validity or root,
    or the two winners' plain t within the sum of their dt). A miss has
    t = FLT_MAX and zero features. Raises AssertionError otherwise;
    returns the counts (lanes, hits, differing winners, those explained
    by a flip and by a near tie, agreeing lanes whose root may flip, the
    largest |t − t_plain| on the other agreeing hits and its bound)."""
    tk, ik, fk = kern
    tp, ip, fp = plain
    n = ik.numel()
    tmax = _tmax_vector(t_max, n, origin.x)
    fk, fp = torch.stack(list(fk)), torch.stack(list(fp))
    miss = ik < 0
    if not (bool((tk[miss] == FLT_MAX).all())
            and bool((fk[:, miss] == 0).all())):
        raise AssertionError("a miss lane has t != FLT_MAX or features")
    same = ik == ip
    hit = same & ~miss
    if not torch.equal(fk[:, hit], fp[:, hit]):
        raise AssertionError("features differ where the winners agree")
    _, _, dt, flip = mx_pair_error(origin, direction,
                                   _lane_rows(centers, radii, ik), t_min,
                                   tmax, lanes=True)
    gap = (tk.double() - tp.double()).abs()
    far = hit & ~flip & (gap > dt)
    if bool(far.any()):
        j = int(far.nonzero()[0])
        raise AssertionError(f"t leaves the plain version's beyond the "
                             f"bound on {int(far.sum())} lanes (lane {j}: "
                             f"{gap[j].item():.3e} > {dt[j].item():.3e})")
    ok = hit & ~flip
    out = dict(lanes=n, hits=int(hit.sum()), differ=0, by_flip=0, by_tie=0,
               root_flips=int((hit & flip).sum()),
               t_err=gap[ok].max().item() if bool(ok.any()) else 0.0,
               t_bound=dt[ok].max().item() if bool(ok.any()) else 0.0)
    dep = (~same).nonzero().flatten()
    if dep.numel():
        sub = lambda v: V3(*(c[dep] for c in v))
        o, d, tm = sub(origin), sub(direction), tmax[dep]
        ts_k, _, dt_k, flip_k = mx_pair_error(
            o, d, _lane_rows(centers, radii, ik[dep]), t_min, tm, lanes=True)
        _, _, dt_p, flip_p = mx_pair_error(
            o, d, _lane_rows(centers, radii, ip[dep]), t_min, tm, lanes=True)
        flip_k = flip_k & (ik[dep] >= 0)
        flip_p = flip_p & (ip[dep] >= 0)
        tie = ((ik[dep] >= 0) & (ip[dep] >= 0)
               & torch.isfinite(dt_k + dt_p)
               & ((ts_k.double() - tp[dep].double()).abs() <= dt_k + dt_p))
        if not bool((flip_k | flip_p | tie).all()):
            raise AssertionError(
                f"the winner departs from the plain version's on "
                f"{int((~(flip_k | flip_p | tie)).sum())} lanes the bound "
                f"cannot flip")
        out.update(differ=dep.numel(), by_flip=int((flip_k | flip_p).sum()),
                   by_tie=int((tie & ~(flip_k | flip_p)).sum()))
    return out


def mx_anyhit_departures(origin: V3, direction: V3, centers: V3,
                         radii: torch.Tensor, t_min: float, t_max, occ,
                         occ_plain) -> dict:
    """Hold the kernel's occlusion ``occ`` to the plain version's by the
    bound: a lane the kernel calls occluded and the plain version not has
    a sphere whose validity the bound can flip; a lane the plain version
    calls occluded and the kernel not has every plain-valid sphere so.
    Raises AssertionError otherwise; returns the counts (lanes, occluded,
    differing lanes)."""
    n = occ.numel()
    tmax = _tmax_vector(t_max, n, origin.x)
    dep = (occ != occ_plain).nonzero().flatten()
    tab = mx_sphere_table(centers, radii)
    for a in range(0, dep.numel(), S_CHUNK):
        lanes = dep[a:a + S_CHUNK]
        sub = lambda v: V3(*(c[lanes] for c in v))
        _, valid, _, flip = mx_pair_error(sub(origin), sub(direction), tab,
                                          t_min, tmax[lanes])
        extra = occ[lanes]  # occluded by the kernel alone
        ok = torch.where(extra, flip.any(dim=1), (flip | ~valid).all(dim=1))
        if not bool(ok.all()):
            raise AssertionError(
                f"occlusion departs from the plain version's on "
                f"{int((~ok).sum())} lanes the bound cannot flip")
    return dict(lanes=n, occluded=int(occ.sum()), differ=dep.numel())


def _mx_sphere_ts(origin: V3, direction: V3, tab: torch.Tensor,
                  t_min: float, tmax: torch.Tensor) -> torch.Tensor:
    """``_sphere_ts`` for the mx table chunk ``tab`` [C, 8]:
    b = o·d − c·d, c = (|o|² − 2·o·c) + (|c|² − r²·sign), in
    ``pallas_spheres._bc_mxu``'s operation order."""
    o1, o2, o3 = origin
    d1, d2, d3 = direction
    od = d1 * o1 + d2 * o2 + d3 * o3
    oo = o1 * o1 + o2 * o2 + o3 * o3
    cd, oc = mx_products(origin, direction, tab)
    b = od[:, None] - cd
    c = oo[:, None] - 2.0 * oc + tab[:, 3]
    return _root_ts(b, c, t_min, tmax)


def mx_error(origin: V3, direction: V3, centers: V3, radii: torch.Tensor,
             idx: torch.Tensor, t_min: float):
    """The mx layout's error against the exact form, per lane for the
    sphere ``idx`` (>= 0), in float64: (dt, flip). Each split operand is
    off by at most 2⁻¹⁶ of itself and each dropped term lo·lo by 2⁻¹⁶ of
    the product, so c·d is within 2⁻¹⁴·|c| and o·c within 2⁻¹⁴·|o|·|c|
    (|d| = 1), to which the f32 roundings add 2⁻²¹ of the terms' size.
    ``dt`` bounds the error of either root to first order,
    δb·(1 + |b|/√disc) + δc/(2√disc); ``flip`` marks a lane whose outcome
    for the sphere those errors can change: disc within its error of 0,
    or a root within ``dt`` of t_min. Lanes with idx < 0 get (0, False)."""
    f64 = torch.float64
    s = idx.clamp_min(0).long()
    o = torch.stack(list(origin), 1).to(f64)
    d = torch.stack(list(direction), 1).to(f64)
    tab = sphere_table(centers, radii).to(f64)[s]
    c, r2 = tab[:, :3], tab[:, 3]
    oc = o - c
    b = (oc * d).sum(1)
    disc = b * b - ((oc * oc).sum(1) - r2)
    on, cn = o.norm(dim=1), c.norm(dim=1)
    db = 2.0 ** -14 * cn + 2.0 ** -21 * (on + cn)
    dc = 2.0 ** -13 * on * cn + 2.0 ** -21 * ((on + cn) ** 2 + r2.abs())
    ddisc = 2.0 * b.abs() * db + db * db + dc
    sq = torch.sqrt(disc.clamp_min(0.0))
    sq_ = sq.clamp_min(1e-300)  # disc = 0: dt is infinite
    dt = db * (1.0 + b.abs() / sq_) + dc / (2.0 * sq_)
    near = (-b - sq - t_min).abs() <= dt
    far = (-b + sq - t_min).abs() <= dt
    hit = idx >= 0
    flip = hit & ((disc.abs() <= ddisc) | near | far)
    return torch.where(hit, dt, 0.0), flip


def _table_and_ts(centers, radii, mx):
    if mx:
        return mx_sphere_table(centers, radii), _mx_sphere_ts
    return sphere_table(centers, radii), _sphere_ts


def _spheres_hit_ref(origin, direction, centers, radii, t_min, t_max,
                     mx=False):
    """(t, idx) by chunks over the spheres: the first minimum of each
    chunk, merged by strict < — the kernel's first-wins order."""
    n = origin.x.shape[0]
    tab, ts_fn = _table_and_ts(centers, radii, mx)
    tmax = _tmax_vector(t_max, n, origin.x)
    t_best = torch.full_like(tmax, FLT_MAX)
    i_best = torch.full((n,), -1, dtype=torch.int32, device=tmax.device)
    for base in range(0, tab.shape[0], S_CHUNK):
        ts = ts_fn(origin, direction, tab[base:base + S_CHUNK], t_min, tmax)
        tloc, jloc = torch.min(ts, dim=1)  # first index of the minimum
        better = tloc < t_best
        t_best = torch.where(better, tloc, t_best)
        i_best = torch.where(better, (jloc + base).to(torch.int32), i_best)
    return t_best, i_best


def _spheres_hit_feat_ref(origin, direction, centers, radii, feat, t_min,
                          t_max, mx=False):
    t, idx = _spheres_hit_ref(origin, direction, centers, radii, t_min, t_max,
                              mx)
    hit = idx >= 0
    rows = feat[idx.clamp_min(0).to(torch.int64)]
    rows = torch.where(hit[:, None], rows, 0.0)
    return t, idx, tuple(rows.t().contiguous().unbind(0))


def _spheres_anyhit_ref(origin, direction, centers, radii, t_min, t_max,
                        mx=False):
    n = origin.x.shape[0]
    tab, ts_fn = _table_and_ts(centers, radii, mx)
    tmax = _tmax_vector(t_max, n, origin.x)
    occ = torch.zeros((n,), dtype=torch.bool, device=tmax.device)
    for base in range(0, tab.shape[0], S_CHUNK):
        ts = ts_fn(origin, direction, tab[base:base + S_CHUNK], t_min, tmax)
        occ = occ | (ts < FLT_MAX).any(dim=1)
    return occ


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _launcher(mx: bool = False):
    """The launch function of csrc/spheres.cu, or of spheres_mx.cu (the
    same arguments but ``tmax_all``: it always takes the [N] t_max)."""
    lib = _build.load("spheres_mx" if mx else "spheres")
    fn = lib.spheres_mx_launch if mx else lib.spheres_hit_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        tmax = [p] if mx else [p, ctypes.c_float]
        fn.argtypes = ([ctypes.c_int] + [p] * 6 + tmax
                       + [p, ctypes.c_int, p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float] + [p] * 5)
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, a: torch.Tensor, device, dtype, shape) -> None:
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, expected {device}")
    if a.dtype != dtype:
        raise TypeError(f"{name} is {a.dtype}, expected {dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                         f"{tuple(shape)}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_table(tab: torch.Tensor, radii: torch.Tensor, dev,
                 mx: bool = False) -> None:
    """Raise unless ``tab`` is the [S, 4] float32 table on ``dev`` for the
    S spheres of ``radii``, contiguous and 16-byte aligned (float4); for
    ``mx``, the [S_pad, 5] int32 table of :func:`mx_operands`."""
    if mx:
        shape = (-(-radii.shape[0] // MX_CHUNK) * MX_CHUNK, 5)
        if tuple(tab.shape) != shape:
            raise ValueError(f"mx sphere table has shape {tuple(tab.shape)},"
                             f" expected {shape}")
        _check("spheres", tab, dev, torch.int32, shape)
        return
    _check("spheres", tab, dev, torch.float32, (radii.shape[0], 4))
    if tab.data_ptr() % 16:
        raise ValueError("sphere table must be 16-byte aligned (float4)")


def _launch(mode: int, origin: V3, direction: V3, centers: V3,
            radii: torch.Tensor, t_min: float, t_max, feat=None, mx=False,
            tab=None):
    """Check the inputs, allocate the outputs and launch one mode of the
    kernel (``mx``: of csrc/spheres_mx.cu) on the current stream; ``tab``
    the kernel's prebuilt table of the spheres, else built here. A float
    ``t_max`` goes to csrc/spheres.cu as one value, not as an [N]
    tensor."""
    global LAUNCHES, MX_PRODUCT_LAUNCHES
    dev = origin.x.device
    n = origin.x.shape[0]
    f32 = torch.float32
    for name, a in zip(("ox", "oy", "oz", "dx", "dy", "dz"),
                       (*origin, *direction)):
        _check(name, a, dev, f32, (n,))
    tmax, tmax_all = None, 0.0
    if mode == _MX_PRODUCTS:
        pass  # no t_max
    elif mx or isinstance(t_max, torch.Tensor):
        tmax = _tmax_vector(t_max, n, origin.x)
        _check("t_max", tmax, dev, f32, (n,))
    else:
        tmax_all = float(t_max)
    if tab is None:
        tab = (mx_operands if mx else sphere_table)(centers, radii)
    _check_table(tab, radii, dev, mx)
    s = radii.shape[0]
    n_c = 0
    if feat is not None:
        n_c = feat.shape[1]
        _check("feat", feat, dev, f32, (s, n_c))

    ptr = lambda a: None if a is None else a.data_ptr()
    t_out = idx_out = f_out = occ_out = None
    if mode == _ANY_HIT:
        occ_out = torch.empty((n,), dtype=torch.bool, device=dev)
    elif mode == _MX_PRODUCTS:
        t_out = torch.empty((n, s), dtype=f32, device=dev)
        f_out = torch.empty((n, s), dtype=f32, device=dev)
    else:
        t_out = torch.empty((n,), dtype=f32, device=dev)
        idx_out = torch.empty((n,), dtype=torch.int32, device=dev)
        if mode == _FEATURES:
            f_out = torch.empty((n_c, n), dtype=f32, device=dev)
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            tm = [ptr(tmax)] if mx else [ptr(tmax), tmax_all]
            rc = _launcher(mx)(
                mode, *(a.data_ptr() for a in (*origin, *direction)), *tm,
                tab.data_ptr(), s, ptr(feat), n_c, n, float(t_min),
                ptr(t_out), ptr(idx_out), ptr(f_out), ptr(occ_out), stream)
        if rc != 0:
            raise RuntimeError(f"spheres{' mx' if mx else ''} kernel launch "
                               f"failed: CUDA error {rc}")
        if mode == _MX_PRODUCTS:
            MX_PRODUCT_LAUNCHES += 1
        elif mx:
            MX_LAUNCHES[_MX_MODE_NAMES[mode]] += 1
        else:
            LAUNCHES += 1
    if mode == _ANY_HIT:
        return occ_out
    if mode == _MX_PRODUCTS:
        return t_out, f_out
    if mode == _FEATURES:
        return t_out, idx_out, tuple(f_out.unbind(0))
    return t_out, idx_out


def _on_cuda(origin: V3) -> bool:
    dev = origin.x.device
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no intersection kernel for tensors on {dev}")


# ---------------------------------------------------------------------------
# public entry points (names of the JAX package's)
# ---------------------------------------------------------------------------


def _cpu_table(tab: Optional[torch.Tensor], radii: torch.Tensor,
               origin: V3, mx: bool = False) -> None:
    """The CPU path checks a prebuilt table as the kernel's does; the
    plain versions build their own from the columns."""
    if tab is not None:
        _check_table(tab, radii, origin.x.device, mx)


def spheres_hit_feat(origin: V3, direction: V3, centers: V3,
                     radii: torch.Tensor, feat: torch.Tensor, t_min: float,
                     t_max, mx: bool = False, *,
                     tab: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """Nearest sphere hit + the winner's feature row.

    origin/direction: V3 of [N]; centers: V3 of [S]; radii [S]; feat
    [S, C] per-sphere features; t_max a float or [N]; ``mx`` the MXU b/c
    layout (module docstring); ``tab`` the spheres' :func:`sphere_table`
    (``mx``: :func:`mx_sphere_table`), if the caller built it (checked,
    not compared).
    Returns (t [N], idx [N] int32, feats: tuple of C [N] tensors, zero on
    a miss).
    """
    if _on_cuda(origin):
        return _launch(_FEATURES, origin, direction, centers, radii, t_min,
                       t_max, feat, mx, tab)
    _cpu_table(tab, radii, origin, mx)
    return _spheres_hit_feat_ref(origin, direction, centers, radii, feat,
                                 t_min, t_max, mx)


def spheres_hit_soa(origin: V3, direction: V3, centers: V3,
                    radii: torch.Tensor, t_min: float, t_max, *,
                    tab: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest sphere hit: (t [N] with FLT_MAX on a miss, idx [N] int32,
    −1 on a miss)."""
    if _on_cuda(origin):
        return _launch(_NEAREST, origin, direction, centers, radii, t_min,
                       t_max, tab=tab)
    _cpu_table(tab, radii, origin)
    return _spheres_hit_ref(origin, direction, centers, radii, t_min, t_max)


def spheres_mx_products(origin: V3, direction: V3, centers: V3,
                        radii: torch.Tensor, *,
                        tab: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cd, oc), each [N, S]: the mx layout's two split products of every
    ray against every sphere, on a CUDA device as the kernel's tensor
    cores sum them (its products mode; ``tab`` as for ``mx=True``), on the
    CPU by :func:`mx_products`. For the checks of
    :func:`mx_product_bound`; no frame takes it."""
    if _on_cuda(origin):
        return _launch(_MX_PRODUCTS, origin, direction, centers, radii, 0.0,
                       None, mx=True, tab=tab)
    _cpu_table(tab, radii, origin, mx=True)
    return tuple(mx_products(origin, direction,
                             mx_sphere_table(centers, radii)))


def spheres_anyhit_soa(origin: V3, direction: V3, centers: V3,
                       radii: torch.Tensor, t_min: float,
                       t_max, mx: bool = False, *,
                       tab: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] bool: any sphere hit in (t_min, t_max) — the shadow test
    (``mx``: by the MXU b/c layout)."""
    if _on_cuda(origin):
        return _launch(_ANY_HIT, origin, direction, centers, radii, t_min,
                       t_max, mx=mx, tab=tab)
    _cpu_table(tab, radii, origin, mx)
    return _spheres_anyhit_ref(origin, direction, centers, radii, t_min,
                               t_max, mx)
