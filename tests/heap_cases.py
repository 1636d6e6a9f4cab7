"""The heap BVH kernel's contract cases (K5 nearest, K6 any-hit), as numpy
inputs: shared by the CPU tests against the JAX package
(``test_torch_heap.py``) and the card's tests against the plain walk
(``test_torch_cuda.py``). Imports no JAX.

The kernel splits a leaf's slots over several lanes and merges their
(t, slot) pairs, and its fast_math mode takes Moller-Trumbore's
reciprocal from the hardware's approximation. The cases are where that
can break. Most are ``bvh_mx_cases``' layouts, whose dyadic coordinates
make the exact test's products and sums exact as well:
  * exact t ties between slots a lane apart and a group apart;
  * leaf widths of 5, 33 and 64 through the builders;
  * slots with |a| < 1e-7 (with the exact test's own answer);
  * a t_max inside a leaf's hits;
  * dead and NaN t_max;
  * sentinel padding;
  * a winner after several passing slots of larger t.
Added here:
  * ties in leaves of 5 and 33 slots, where the lower slot of the tie sits
    in a later lane than the higher one's second round;
  * a slot whose u and v are NaN while its a and t are finite (the
    ``neg`` rule of pt::mt_hit), in every summation order, so also where
    XLA contracts multiply-adds into FMAs; ``bvh_mx_cases``' NaN slot
    makes u NaN only in the split-bf16 form;
  * slots whose exact u, v, u + v or t lies within 2^-20 of an accept
    bound, on either side: the fast_math reciprocal (about 1 ulp) and
    the test's own rounding stay inside that margin, so every mode takes
    the same winners.
"""

import numpy as np

from bvh_mx_cases import (BELOW, OFF, T_MIN, UNIT, Case, _leaf, _winner,
                          down_rays, layout, plane, port_mesh, soup)
import bvh_mx_cases

from tpu_pathtracer_torch.ops.vec import FLT_MAX

__all__ = ["CASES", "T_MIN", "case", "port_mesh", "soup"]

# bvh_mx_cases' NaN slot is one of the split-bf16 form
# bvh_mx_cases' layouts; its NaN slot is one of the split-bf16 form, and
# its small_a check takes the split test's answer on one lane
SHARED = [c for c in bvh_mx_cases.CASES if c not in ("nan_u", "small_a")]
CASES = SHARED + ["small_a", "tie_w5", "tie_w33", "nan_u", "near_bound"]
# (P, BELOW's slot, the tie's slots): the lower slot wins
TIES = {"tie_w5": (5, 0, (3, 4)), "tie_w33": (33, 1, (31, 32))}
DELTA = 2.0 ** -20  # the margin of the near_bound slots


def _near_bound() -> Case:
    """Slot 3: a triangle with legs 3 at z = 0 (a = 9, so 1/a rounds);
    rays straight down hit it at u = x / 3, v = y / 3, t = oz. Slot 40:
    a wide triangle at z = -3 under it. Each lane's exact u, v, u + v or
    t lies DELTA (or DELTA / 2 for u + v) inside or outside a bound."""
    P = 64
    wide = plane(-3.0, -4.0, -4.0, 16.0)
    tri3 = [[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [0.0, 3.0, 0.0]]
    slots = layout([_leaf(P, OFF, {3: tri3, 40: wide}), [OFF]], P)
    f32 = np.float32
    lo = f32(T_MIN)
    e, h = 3 * DELTA, DELTA / 2
    # x, y, oz, t_max, the winning slot (-1: none)
    lanes = [
        (1.5, 1.5 - 3 * h, 5.0, FLT_MAX, 3),    # u + v = 1 - h
        (1.5, 1.5 + 3 * h, 5.0, FLT_MAX, 40),   # u + v = 1 + h
        (e, 1.0, 5.0, FLT_MAX, 3),              # u = DELTA
        (-e, 1.0, 5.0, FLT_MAX, 40),            # u = -DELTA
        (1.0, e, 5.0, FLT_MAX, 3),              # v = DELTA
        (1.0, -e, 5.0, FLT_MAX, 40),            # v = -DELTA
        (1.0, 1.0, 5.0, 5.0 * (1 + DELTA), 3),  # t = t_max / (1 + DELTA)
        (1.0, 1.0, 5.0, 5.0 * (1 - DELTA), -1),
        (1.0, 1.0, lo * (1 + DELTA), FLT_MAX, 3),   # t above t_min
        (1.0, 1.0, lo * (1 - DELTA), FLT_MAX, 40),  # t below it
    ]
    lanes = [lanes[k % len(lanes)] for k in range(64)]
    o = np.array([[x, y, oz] for x, y, oz, _, _ in lanes], f32)
    d = np.zeros_like(o)
    d[:, 2] = -1.0
    tm = np.array([t for _, _, _, t, _ in lanes], f32)
    want = np.array([k for *_, k in lanes], np.int32)
    # the winner's exact t: oz over slot 3, oz + 3 over slot 40
    t_hit = np.where(want == 3, o[:, 2].astype(np.float64),
                     o[:, 2] + 3.0)

    def check(t, tri, occ, cnt):
        np.testing.assert_array_equal(tri, want)
        hit = want >= 0
        np.testing.assert_allclose(t[hit], t_hit[hit], rtol=1e-6)
        np.testing.assert_array_equal(t[~hit], tm[~hit])
        np.testing.assert_array_equal(occ, hit)
    return Case(o, d, tm, slots, None, P, check)


def _nan_u() -> Case:
    """Slot 40: a triangle in the plane x = 0 with e1 = (0, 2^127, 0), e2
    = (0, 0, 1); rays from (-0.5, 2^127, z0) along (0.5, 0, 2) meet the
    plane at t = 1, while q's x component, 2^127 * 2, overflows to +inf
    and meets e1's and e2's zero x components: u and v are inf * 0 = NaN
    in every summation order, a = -2^126 and t are finite. The test
    accepts it (a NaN u never counts as < 0) over slot 5, hit at t = 2 in
    the plane x = 0.5 (u = z0, v = 0.5)."""
    P = 64
    big = 2.0 ** 127
    nan_slot = [[0.0, 0.0, 0.0], [0.0, big, 0.0], [0.0, 0.0, 1.0]]
    y0 = 0.75 * big
    behind = [[0.5, y0, 4.0], [0.5, y0 + big / 2, 4.0], [0.5, y0, 5.0]]
    slots = layout([_leaf(P, OFF, {5: behind, 40: nan_slot}), [OFF]], P)
    o = np.zeros((64, 3), np.float32)
    o[:, 0] = -0.5
    o[:, 1] = big
    o[:, 2] = 0.25 + np.arange(64) / 256.0
    d = np.broadcast_to(np.float32([0.5, 0.0, 2.0]), o.shape).copy()
    return Case(o, d, np.full(64, FLT_MAX, np.float32), slots, None, P,
                _winner(40, 1.0))


def _small_a() -> Case:
    """``bvh_mx_cases``' slivers, with the exact test's answer: the lanes
    over slot 20's sliver (its cross-section at the rays' y spans x in
    [9 + 2^-8, 9 + 2^-5 - 2^-8], bounds included) take it, the others
    the plane under it (slot 40) at t = 5; slot 7 (|a| < 1e-7) never."""
    c = bvh_mx_cases.case("small_a")
    x = c.o[:, 0]
    over = (x >= 9.0 + 2.0 ** -8) & (x <= 9.0 + 2.0 ** -5 - 2.0 ** -8)

    def check(t, tri, occ, cnt):
        np.testing.assert_array_equal(tri, np.where(over, 20, 40))
        np.testing.assert_array_equal(t, np.where(over, 4.0, 5.0))
        assert occ.all()
    return c._replace(check=check)


def case(name) -> Case:
    if name in SHARED:
        return bvh_mx_cases.case(name)
    if name in TIES:
        P, below, (a, b) = TIES[name]
        o, d = down_rays(64, 5.0, seed=1)
        slots = layout([_leaf(P, OFF, {below: BELOW, a: UNIT, b: UNIT}),
                        [OFF]], P)
        return Case(o, d, np.full(64, FLT_MAX, np.float32), slots, None, P,
                    _winner(a, 5.0))
    if name == "nan_u":
        return _nan_u()
    if name == "small_a":
        return _small_a()
    if name == "near_bound":
        return _near_bound()
    raise KeyError(name)
