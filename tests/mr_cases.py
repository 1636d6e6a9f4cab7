"""The packet walk's merge cases (K12a nearest, K12b any-hit), as numpy
inputs: shared by the CPU tests of the split-and-merge model
(``test_torch_bvh_mr.py``) and the card's tests against the plain walk
(``test_torch_cuda.py``). Imports no JAX.

The kernel deals a leaf round's slots to the W warps of a packet (slot
s of a leaf to warp s mod W) and merges their (t, key) pairs, key =
(queue position, slot). The cases are where that can break:
  * ``tie_queue``: two queued leaves hit at the same t, the later-queued
    one holding the lower heap slot (leaf 1's box reaches higher, so the
    vote queues it first). The serial walk keeps the earlier-queued
    leaf's slot, not the lower heap slot; leaf 0's slot 1 is the only hit
    of its warp at W = 2, 4 and 8, and leaf 1's equal-t slots 2 and 4 fall
    to different warps at W = 4 and 8. Every lane hits in the first leaf
    round, so the any-hit packet retires there;
  * ``tie_warps``: two equal-t slots of one leaf, 3 and 4, in different
    warps at W = 2, 4 and 8, the higher slot in the lower warp at W = 2
    and 4: the lower slot wins;
  * ``one_leaf``: a tree of one leaf (first_leaf 1): the root is queued
    at once and the walk ends after one leaf round.
"""

import numpy as np

from bvh_mx_cases import OFF, UNIT, Case, _leaf, down_rays, layout, \
    plane, port_mesh

from tpu_pathtracer_torch.ops.vec import FLT_MAX

__all__ = ["CASES", "case", "port_mesh"]

CASES = ["tie_queue", "tie_warps", "one_leaf"]
P = 8
HIGH_OFF = plane(1.0, 50.0, 50.0, 1.0)  # off every ray, above UNIT


def _check(slot, counters):
    """The case's own check of the kernel's or the walk's outputs: every
    lane's winner at t = 5, every lane occluded, and the one packet's
    counters (nodes_both, nodes_single, leaf_visits) in both modes."""
    def check(t, tri, occ, cnt_near, cnt_any):
        assert (tri == slot).all() and (t == np.float32(5.0)).all()
        assert occ.all()
        for cnt in (cnt_near, cnt_any):
            assert cnt[:, 0].tolist() == list(counters)
    return check


def case(name) -> Case:
    o, d = down_rays(64, 5.0, seed=3)
    t_max = np.full(len(o), FLT_MAX, np.float32)
    if name == "tie_queue":
        # leaf 0: UNIT at slot 1 (heap slot 1); leaf 1: UNIT at slots 2
        # and 4 (heap 10, 12), HIGH_OFF at slot 7 (its box's top at z = 1:
        # entered at t = 4, before leaf 0's at t = 5)
        slots = layout([_leaf(P, OFF, {1: UNIT}),
                        _leaf(P, OFF, {2: UNIT, 4: UNIT, 7: HIGH_OFF})], P)
        return Case(o, d, t_max, slots, None, P, _check(10, (1, 0, 2)))
    if name == "tie_warps":
        # leaf 1 only: UNIT at slots 3 and 4 (heap 11, 12)
        slots = layout([_leaf(P, OFF, {}),
                        _leaf(P, OFF, {3: UNIT, 4: UNIT})], P)
        return Case(o, d, t_max, slots, None, P, _check(11, (0, 1, 1)))
    if name == "one_leaf":
        slots = layout([_leaf(P, OFF, {5: UNIT})], P, num_leaves=1)
        return Case(o, d, t_max, slots, None, P, _check(5, (0, 0, 1)))
    raise KeyError(name)
