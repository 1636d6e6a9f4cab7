"""The MXU-leaf heap kernel's contract cases, as numpy inputs: shared by
the CPU tests against the JAX package (``test_torch_bvh_mx.py``) and the
card's tests against the plain walk (``test_torch_cuda.py``). Imports no
JAX.

A case is a heap layout (``slots``: the [num_leaves * P, 3] f32 vertex
arrays in slot order, +inf in sentinel slots, which both packages'
``_node_boxes`` and ``MeshData`` take as ``build_bvh`` makes them) or a
random soup through the builders (``soup``), with rays, their t_max and
a check of the walk's outputs. The cases are where a kernel that splits
a leaf's slots over several lanes can break: exact t ties between slots
a lane and a group apart, leaf widths that are no multiple of a group,
slots with |a| < 1e-7, a NaN u, a t_max inside a leaf's hits, dead and
NaN t_max, sentinel padding, and a winner after several passing slots
of larger t. The hand-made layouts use dyadic coordinates with few
bits, so every split-bf16 product and sum is exact: the JAX kernel,
whatever its summation order, gives the same values.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np

from tpu_pathtracer_torch.ops.vec import FLT_MAX

T_MIN = 1e-3
CASES = ["tie_1", "tie_8", "tie_16", "tie_32", "late_winner",
         "t_max_cuts_leaf", "sentinel_padding", "small_a", "nan_u",
         "dead_lanes", "soup_w5", "soup_w33", "soup_w64"]
TIES = {"tie_1": (5, 6), "tie_8": (5, 13), "tie_16": (5, 21),
        "tie_32": (3, 35)}


class Case(NamedTuple):
    o: np.ndarray
    d: np.ndarray
    t_max: np.ndarray          # [N] f32
    slots: Optional[tuple]     # (v0, v1, v2) [num_leaves * P, 3], or
    soup: Optional[dict]       # t, seed: a random soup through build_bvh
    P: int
    check: Callable            # check(t, tri, occ, cnt) of the walk


def plane(z, x0=0.0, y0=0.0, size=2.0):
    """A right triangle at height z with legs ``size`` along x and y from
    (x0, y0): rays straight down over [x0, x0 + size/2]^2 hit it at
    t = height - z."""
    return [[x0, y0, z], [x0 + size, y0, z], [x0, y0 + size, z]]


OFF = plane(0.0, 50.0, 50.0, 1.0)   # off every ray
UNIT = plane(0.0)                   # under the rays: t = 5 from z = 5
BELOW = plane(-3.0)                 # under that: t = 8


def down_rays(n, z, seed, lo=0.25, hi=0.875):
    """n rays straight down (-z) from height z over [lo, hi]^2, at
    multiples of 1/256 (dyadic: exact after recentering)."""
    rng = np.random.RandomState(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.randint(int(lo * 256), int(hi * 256), (n, 2)) / 256.0
    o[:, 2] = z
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    return o, d


def layout(leaves, P, num_leaves=2):
    """The slot arrays of ``leaves`` (lists of triangles, leaf l at slots
    l * P ...), +inf in every other slot."""
    v = np.full((num_leaves * P, 3, 3), np.inf, np.float32)
    for li, tris in enumerate(leaves):
        assert len(tris) <= P
        for k, tri in enumerate(tris):
            if tri is not None:
                v[li * P + k] = np.asarray(tri, np.float32)
    return v[:, 0], v[:, 1], v[:, 2]


def _leaf(P, fill, at):
    """A leaf of P slots: ``fill`` everywhere, ``at`` {slot: triangle}."""
    tris = [fill] * P
    for k, tri in at.items():
        tris[k] = tri
    return tris


def _winner(slot, t):
    def check(tt, tri, occ, cnt):
        assert (tri == slot).all() and (tt == np.float32(t)).all()
        assert occ.all() and (cnt[2] >= 1).all() and (cnt[3] == 0).all()
    return check


def soup(t, seed):
    """A random triangle soup, off the origin so that G is recentred."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-10, 10, (t, 3)).astype(np.float32) + 30.0
    v1 = base + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v2 = base + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    return base, v1, v2


def soup_rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32) + 30.0
    d = rng.uniform(-8, 8, (n, 3)).astype(np.float32) + 30.0 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def case(name) -> Case:
    fmax = lambda n: np.full(n, FLT_MAX, np.float32)
    if name in TIES:
        # UNIT at both slots (an exact tie: the lower slot wins), BELOW at
        # slot 2, OFF elsewhere
        a, b = TIES[name]
        o, d = down_rays(64, 5.0, seed=1)
        P = 64
        slots = layout([_leaf(P, OFF, {2: BELOW, a: UNIT, b: UNIT}),
                        [OFF]], P)
        return Case(o, d, fmax(len(o)), slots, None, P, _winner(a, 5.0))
    if name == "late_winner":
        # slots 2, 9, 17, 40 pass with t 9, 8, 7, 6 (each beats the one
        # before it in slot order), slot 50 wins at t = 5, slot 60 passes
        # the entry closest at t = 7 after it
        P = 64
        at = {2: plane(-4.0), 9: plane(-3.0), 17: plane(-2.0),
              40: plane(-1.0), 50: UNIT, 60: plane(-2.0)}
        o, d = down_rays(64, 5.0, seed=2)
        slots = layout([_leaf(P, OFF, at), [OFF]], P)
        return Case(o, d, fmax(len(o)), slots, None, P, _winner(50, 5.0))
    if name == "t_max_cuts_leaf":
        # BELOW at slot 1 (t = 8), UNIT at slot 30 (t = 5); t_max 4.5
        # misses both, 6 takes UNIT, 8 (not < 8) UNIT, 9 UNIT
        P = 64
        slots = layout([_leaf(P, OFF, {1: BELOW, 30: UNIT}), [OFF]], P)
        o, d = down_rays(64, 5.0, seed=3)
        tm = np.resize(np.array([4.5, 6.0, 8.0, 9.0], np.float32), 64)

        def check(t, tri, occ, cnt):
            short = tm < 5.0
            assert (tri[short] == -1).all() and (t[short] == tm[short]).all()
            assert (tri[~short] == 30).all() and (t[~short] == 5.0).all()
            assert (occ == ~short).all()
        return Case(o, d, tm, slots, None, P, check)
    if name == "sentinel_padding":
        # three live slots and 61 sentinels in leaf 0; leaf 1 all
        # sentinels (its box is empty: never entered)
        P = 64
        slots = layout([[BELOW, OFF, UNIT]], P)
        o, d = down_rays(64, 5.0, seed=4)

        def check(t, tri, occ, cnt):
            _winner(2, 5.0)(t, tri, occ, cnt)
            assert (cnt[2] == 1).all()
        return Case(o, d, fmax(len(o)), slots, None, P, check)
    if name == "small_a":
        # two slivers at z = 1 (t = 4) over the rays' strip y in
        # (8, 8 + 2^-19): |a| = 2^-24 < 1e-7 (slot 7, x in [8, 8 + 2^-6],
        # never accepted) and 2^-23 >= 1e-7 (slot 20, x in [9, 9 + 2^-5],
        # the winner); a plane under both at z = 0 (slot 40, t = 5)
        P = 64
        h = 2.0 ** -18
        thin = lambda x0, w: [[x0, 8.0, 1.0], [x0 + w, 8.0, 1.0],
                              [x0 + w / 2, 8.0 + h, 1.0]]
        at = {7: thin(8.0, 2.0 ** -6), 20: thin(9.0, 2.0 ** -5),
              40: plane(0.0, 7.0, 7.0, 8.0)}
        slots = layout([_leaf(P, OFF, at), [OFF]], P)
        xs = np.concatenate([8.0 + np.arange(1, 17) * 2.0 ** -11,
                             9.0 + np.arange(10, 58) * 2.0 ** -11])
        o = np.zeros((xs.size, 3), np.float32)
        o[:, 0] = xs
        o[:, 1] = 8.0 + 2.0 ** -20
        o[:, 2] = 5.0
        d = np.zeros_like(o)
        d[:, 2] = -1.0
        narrow = xs < 9.0

        def check(t, tri, occ, cnt):
            assert (tri[narrow] == 40).all() and (t[narrow] == 5.0).all()
            assert (tri[~narrow] == 20).all()
            assert occ.all()
        return Case(o, d, fmax(len(o)), slots, None, P, check)
    if name == "nan_u":
        # slot 12's e2 is so long that u's numerator sums +inf and -inf
        # (u = NaN, not < 0) while a and t stay finite: the test accepts
        # it at t = 4 over UNIT at t = 5 (slot 30); mirrored at slot 13,
        # so the root box stays centred
        P = 64
        big = 2.0 ** 126
        at = {12: [[0.0, 0.0, 1.0], [2.0 ** -100, 0.0, 1.0],
                   [0.0, big, 1.0]],
              13: [[0.0, 0.0, 1.0], [2.0 ** -100, 0.0, 1.0],
                   [0.0, -big, 1.0]],
              30: UNIT}
        slots = layout([_leaf(P, OFF, at), [OFF]], P)
        o, d = down_rays(64, 5.0, seed=5)

        def check(t, tri, occ, cnt):
            assert (tri == 12).all() and (t == 4.0).all() and occ.all()
        return Case(o, d, fmax(len(o)), slots, None, P, check)
    if name == "dead_lanes":
        o, d = soup_rays(320, seed=6)
        tm = np.resize(np.array([-1.0, 0.0, np.nan, FLT_MAX, 9.0],
                                np.float32), 320)

        def check(t, tri, occ, cnt):
            dead = ~(tm > 0)
            assert (tri[dead] == -1).all() and not occ[dead].any()
            assert (cnt[:, dead] == 0).all()
            np.testing.assert_array_equal(t[dead], tm[dead])
            assert (tri[~dead] >= 0).sum() > 10
        return Case(o, d, tm, None, dict(t=1200, seed=7), 64, check)
    if name.startswith("soup_w"):
        P = int(name[len("soup_w"):])
        o, d = soup_rays(320, seed=8)

        def check(t, tri, occ, cnt):
            assert (tri >= 0).sum() > 50 and (tri < 0).sum() > 10
            assert (occ == (tri >= 0)).all()
        return Case(o, d, fmax(len(o)), None, dict(t=1200, seed=9), P,
                    check)
    raise KeyError(name)


def port_mesh(c: Case, device):
    """The port's MeshData of a case (its heap layout, or its soup
    through ``build_bvh``)."""
    import torch
    from tpu_pathtracer_torch.models.scene import MeshData
    from tpu_pathtracer_torch.ops import bvh as tbvh
    if c.soup is not None:
        return tbvh.build_bvh(*soup(**c.soup), prims_per_leaf=c.P,
                              bvh4=False, device=device)
    v0, v1, v2 = c.slots
    nl = v0.shape[0] // c.P
    bmin, bmax = tbvh._node_boxes(v0, v1, v2, nl, c.P)
    t = lambda a: torch.as_tensor(a, device=device)
    n = v0.shape[0]
    return MeshData(v0=t(v0), v1=t(v1), v2=t(v2),
                    tex_coords=t(np.zeros((n, 6), np.float32)),
                    mesh_id=t(np.zeros(n, np.int32)), bvh_min=t(bmin),
                    bvh_max=t(bmax), bounds_min=t(bmin[1]),
                    bounds_max=t(bmax[1]), first_leaf=nl,
                    prims_per_leaf=c.P)
