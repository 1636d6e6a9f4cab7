"""The regrouped heap kernel's contract cases (K11), as numpy inputs:
shared by the CPU tests against the JAX package and the heap walk
(``test_torch_bvh_rg.py``) and the card's tests against the plain walk
(``test_torch_cuda.py``). Imports no JAX.

The kernel walks a ray a thread, records a window of two leaf visits,
tests the window's pairs over several lanes of its warp and merges their
(t, slot) pairs by shuffles, and commits once a window. The cases are
where that can break. ``heap_cases``' layouts and soups (exact t ties
between slots a lane and a group apart, leaf widths 5, 33 and 64, slots
with |a| < 1e-7, a NaN u, a t_max inside a leaf's hits, dead and NaN
t_max, sentinel padding, a winner after several passing slots), and:
  * ``window_tie``: an exact t tie across the two leaves of one window,
    the later-visited leaf holding the lower slot (K11 takes the lower
    slot, the heap kernel the first visited); the heap kernel culls that
    second leaf after the first one's hit, K11 visits it (one more
    visit, the same t);
  * ``cross_window_tie``: a tie across two windows, where the later
    window's equal t must not pass the strict <; that window holds one
    recorded visit, the walk's last;
  * ``divergent_windows``: rays of one warp whose window counts differ
    widely (none, a few, many);
  * ``ragged_n``: 333 rays, no multiple of 32 or 128.
"""

import numpy as np

import heap_cases
from bvh_mx_cases import (OFF, T_MIN, UNIT, Case, _leaf, down_rays, layout,
                          plane, port_mesh, soup, soup_rays)

from tpu_pathtracer_torch.ops.vec import FLT_MAX

__all__ = ["CASES", "T_MIN", "case", "port_mesh", "soup"]

SHARED = list(heap_cases.CASES)
CASES = SHARED + ["window_tie", "cross_window_tie", "divergent_windows",
                  "ragged_n"]
P_STACK = 8  # leaf width of the stacked layouts


def _raise(z):
    """Two triangles at height z off the rays (down_rays' [0.25, 0.875]^2):
    a leaf holding them has a box over the rays, entered at t = 5 - z."""
    return [plane(z, -3.0, -3.0, 1.0), plane(z, 50.0, 50.0, 1.0)]


def _stack(leaves):
    """8 leaves of P_STACK slots, {leaf: triangles}; a leaf not named
    holds OFF (a box off the rays) and padding is OFF too."""
    return layout([_leaf(P_STACK, OFF, dict(enumerate(leaves.get(k, []))))
                   for k in range(8)], P_STACK, num_leaves=8)


def _stacked(name) -> Case:
    """Rays straight down from z = 5 over a tree of 8 leaves (heap nodes
    8..15), each leaf's box entered at 5 - its top. E1 (leaf 7, top 3)
    and E2 (leaf 6, top 2.75) hold no hit and fill the first window;
    A (leaf 11 - 8 = 3, UNIT at slot 3 * 8 + 2) is hit at t = 5.
      window_tie: B (leaf 0, UNIT at slot 1, top 0: entered at t = 5)
        is the only leaf of node 4; the heap kernel culls node 4's
        children after A's hit (5 is not < 5), K11 records B beside A:
        visits 3 and 4, winners slot 26 and slot 1, t = 5.
      cross_window_tie: node 4 holds B (leaf 0, as above) and C (leaf 1,
        no hit, top 2: entered at 3, first); K11 records A and C, commits
        t = 5, then B alone in a window, whose t = 5 does not pass: both
        take slot 26 at t = 5, visits 4 and 5."""
    a = [plane(2.5, -3.0, -3.0, 1.0), plane(2.5, 50.0, 50.0, 1.0), UNIT]
    leaves = {7: _raise(3.0), 6: _raise(2.75), 3: a, 0: [OFF, UNIT]}
    if name == "cross_window_tie":
        leaves[1] = _raise(2.0)
    o, d = down_rays(64, 5.0, seed=11)
    want, visits = (1, 4) if name == "window_tie" else (26, 5)

    def check(t, tri, cnt):
        assert (tri == want).all() and (t == np.float32(5.0)).all()
        assert (cnt[2] == visits).all() and (cnt[3] == 0).all()
    return Case(o, d, np.full(64, FLT_MAX, np.float32), _stack(leaves),
                None, P_STACK, check)


def _divergent() -> Case:
    """A soup of 16-slot leaves; in every warp a lane in four points away
    from it (no window), one stops at t_max = 0.5 (a few), two cross it
    (many)."""
    n = 256
    o, d = soup_rays(n, seed=12)
    k = np.arange(n) % 4
    d[k == 0] = -d[k == 0]
    o[k == 0] = o[k == 0] + 100.0 * d[k == 0]  # past the soup's box
    tm = np.where(k == 1, 0.5, FLT_MAX).astype(np.float32)

    def check(t, tri, cnt):
        warps = cnt[2].reshape(-1, 32)
        assert (warps.min(1) == 0).all() and (warps.max(1) >= 6).all()
        assert (cnt[2, k == 0] == 0).all() and (tri[k == 0] == -1).all()
        assert (tri[k >= 2] >= 0).sum() > 50
    return Case(o, d, tm, None, dict(t=1200, seed=13), 16, check)


def _ragged() -> Case:
    o, d = soup_rays(333, seed=14)

    def check(t, tri, cnt):
        assert (tri >= 0).sum() > 50 and (tri < 0).sum() > 10
    return Case(o, d, np.full(333, FLT_MAX, np.float32), None,
                dict(t=1200, seed=15), 16, check)


def case(name) -> Case:
    """A case whose ``check(t, tri, cnt)`` holds the walk's nearest
    outputs (``heap_cases``' checks take the hit mask as occlusion)."""
    if name in SHARED:
        c = heap_cases.case(name)
        return c._replace(check=lambda t, tri, cnt, f=c.check:
                          f(t, tri, tri >= 0, cnt))
    if name in ("window_tie", "cross_window_tie"):
        return _stacked(name)
    if name == "divergent_windows":
        return _divergent()
    if name == "ragged_n":
        return _ragged()
    raise KeyError(name)
