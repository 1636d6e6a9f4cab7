"""The SAH BVH4 kernel's contract cases, as numpy inputs: shared by the
CPU tests against the JAX package (``test_torch_bvh4.py``) and the card's
tests against the plain walk (``test_torch_cuda.py``). Imports no JAX.

A case is either a hand-made tree (``tree``: the node tables, the leaf
clusters and their triangles, in the form both packages' ``_assemble4``
take) or a random soup through the builders (``soup``), with rays, their
t_max and a check of the plain walk's outputs. The cases are where a
kernel that splits a ray's work over several lanes can break: exact t
ties between slots a lane apart and across lanes, children with equal
entry distance, 0 to 4 hit children and empty refs, widths that are no
multiple of a group, dead and NaN t_max, a t_max inside a leaf's hits and
a walk that fills its ref stack to exactly its capacity.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np

from tpu_pathtracer_torch.ops.vec import FLT_MAX

T_MIN = 1e-3
CASES = ["tie_adjacent", "tie_across_lanes", "equal_entry",
         "hit_children", "hit_children_empty_refs", "empty_refs_live_boxes",
         "t_max_cuts_leaf", "stack_exact", "dead_lanes", "soup_w64",
         "soup_w33", "soup_w64_quant"]
# cases outside the JAX kernels' tables: ops/bvh4 gives every empty slot
# the inverted box, and the JAX packet walk ends at an entered empty slot
NOT_JAX = ["empty_refs_live_boxes"]

# an empty child slot's box (ops/bvh4._collapse4)
INV = np.array([1e30, 1e30, 1e30, -1e30, -1e30, -1e30], np.float32)


class Tree(NamedTuple):
    bounds: np.ndarray   # [n_nodes*24] f32
    refs: np.ndarray     # [n_nodes*4] int32
    clusters: list       # (first, count) into tris
    depth4: int
    tris: np.ndarray     # [T, 3, 3] f32 vertices
    width: int


class Case(NamedTuple):
    o: np.ndarray
    d: np.ndarray
    t_max: np.ndarray            # [N] f32
    tree: Optional[Tree]         # a hand-made tree, or
    soup: Optional[dict]         # t, seed, width, quant: a builder's
    need: Optional[int]          # the deepest ref stack of the walk
    check: Callable              # check(t, tri, occ, cnt) of the walk


def assemble_args(tree: Tree):
    """``_assemble4``'s arguments (both packages') for a hand-made tree,
    the triangles in cluster order and every slot its own heap slot."""
    v = tree.tris
    t = v.shape[0]
    tris = (v[:, 0], v[:, 1], v[:, 2], np.zeros((t, 6), np.float32),
            np.zeros(t, np.int32), np.arange(t, dtype=np.int32))
    return (tris, np.arange(t), tree.bounds, tree.refs, tree.clusters,
            tree.depth4, tree.width)


def soup(t, seed):
    """A random triangle soup, as ``test_torch_bvh4.soup`` makes it."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-10, 10, (t, 3)).astype(np.float32)
    v1 = base + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v2 = base + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    tc = rng.rand(t, 6).astype(np.float32)
    mid = rng.randint(0, 5, t).astype(np.int32)
    return base, v1, v2, tc, mid


def soup_rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.uniform(-8, 8, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def box(tris):
    """The box of some triangles, as six floats."""
    v = np.asarray(tris, np.float32).reshape(-1, 3)
    return np.concatenate([v.min(0), v.max(0)]).astype(np.float32)


def node(boxes, refs):
    """One node's 24 bounds and 4 refs; a missing box is the empty one."""
    b = np.concatenate([INV if x is None else np.asarray(x, np.float32)
                        for x in boxes])
    return b.astype(np.float32), np.asarray(refs, np.int32)


def tree(nodes, clusters, depth4, tris, width):
    return Tree(np.concatenate([b for b, _ in nodes]),
                np.concatenate([r for _, r in nodes]), clusters, depth4,
                np.asarray(tris, np.float32), width)


def down_rays(n, z, seed, lo=0.3, hi=0.9):
    """n rays straight down (-z) from height z over [lo, hi]^2."""
    rng = np.random.RandomState(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(lo, hi, (n, 2))
    o[:, 2] = z
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    return o, d


OFF = [[50, 50, 0], [51, 50, 0], [50, 51, 0]]  # off every ray
UNIT = [[0, 0, 0], [2, 0, 0], [0, 2, 0]]       # under the rays, t = 5
BELOW = [[0, 0, -3], [2, 0, -3], [0, 2, -3]]   # under that, t = 8


def _leaf_tie(slots, width=16):
    """One leaf of `width` slots: UNIT at ``slots`` (an exact tie), BELOW
    at slot 2 and OFF elsewhere; rays from z = 5 hit UNIT at t = 5."""
    tris = [OFF] * width
    tris[2] = BELOW
    for k in slots:
        tris[k] = UNIT
    nodes = [node([box(tris), None, None, None], [-1, 0, 0, 0])]
    o, d = down_rays(64, 5.0, seed=1)

    def check(t, tri, occ, cnt):
        assert (tri == slots[0]).all() and (t == 5.0).all()
    return tree(nodes, [(0, width)], 1, tris, width), o, d, check


def _hit_children(empty, live_boxes=False):
    """A root with four leaf children: child j spans x in [0, 4 - j] at
    z in [j, j + 0.5] and holds a rectangle at z = j + 0.25, so a ray at
    x in (k, k + 1) hits the 4 - k nearest of them (none at x > 4), the
    one of the highest j first. With ``empty``, slots 1 and 3 are empty
    (ref 0, the inverted box); with ``live_boxes`` too, they keep their
    boxes: no ray may enter them all the same."""
    tris, clusters, boxes, refs = [], [], [], []
    for j in range(4):
        x1, z = 4.0 - j, j + 0.25
        leaf = [[[0, 0, z], [x1, 0, z], [0, 1, z]],
                [[x1, 1, z], [0, 1, z], [x1, 0, z]]]
        clusters.append((len(tris), 2))
        tris += leaf
        gone = empty and j % 2
        boxes.append(None if gone and not live_boxes else
                     np.array([0, 0, j, x1, 1, j + 0.5], np.float32))
        refs.append(0 if gone else -(j + 1))
    nodes = [node(boxes, refs)]
    xs = np.repeat([0.5, 1.5, 2.5, 3.5, 5.0], 8).astype(np.float32)
    o = np.zeros((xs.size, 3), np.float32)
    o[:, 0] = xs + np.tile(np.linspace(-0.15, 0.15, 8),
                           5).astype(np.float32)
    o[:, 1] = 0.05  # off the rectangles' diagonals
    o[:, 2] = 10.0
    d = np.zeros_like(o)
    d[:, 2] = -1.0
    live = [j for j in range(4) if not (empty and j % 2)]
    width = 4

    def check(t, tri, occ, cnt):
        nhit = np.array([sum(1 for j in live if x < 4.0 - j)
                         for x in o[:, 0]])
        top = np.array([max([j for j in live if x < 4.0 - j], default=-1)
                        for x in o[:, 0]])
        assert (cnt[0] == (nhit >= 2)).all()
        assert (cnt[1] == (nhit == 1)).all()
        assert (cnt[2] == nhit).all()
        assert (cnt[3] == np.maximum(nhit - 1, 0)).all()
        assert (cnt[4] == 1).all()
        assert (tri == np.where(top >= 0, top * width, -1)).all()
        np.testing.assert_allclose(t[top >= 0],
                                   10.0 - (top[top >= 0] + 0.25), rtol=1e-6)
    return tree(nodes, clusters, 1, tris, width), o, d, check


def _stack_exact(levels=4, width=4):
    """A comb: node m's slot 3 is node m + 1 (the last node's a leaf), the
    nearest child; slots 0-2 are leaves behind it. Every box holds the
    ray, so each level pushes three refs and the walk needs a stack of
    exactly 3 * levels. Every leaf holds UNIT (a tie across leaves): the
    deepest slot-3 leaf, visited first, wins."""
    tris, clusters, nodes = [], [], []
    for m in range(levels):
        boxes, refs = [], []
        for j in range(4):
            top = 50.0 - 10 * m - (0 if j == 3 else 5 + j)
            boxes.append(np.array([-1, -1, -10, 3, 3, top], np.float32))
            if j == 3 and m < levels - 1:
                refs.append(m + 2)  # interior node m + 1
            else:
                clusters.append((len(tris), 1))
                tris.append(UNIT)
                refs.append(-len(clusters))
        nodes.append(node(boxes, refs))
    first = len(clusters) - 1  # the deepest slot-3 leaf
    o, d = down_rays(32, 100.0, seed=2)  # above every box: t = 100

    def check(t, tri, occ, cnt):
        assert (tri == first * width).all() and (t == 100.0).all()
        assert (cnt[2] == 3 * levels + 1).all()
        assert (cnt[3] == 3 * levels).all() and (cnt[4] == levels).all()
    return (tree(nodes, clusters, levels, tris, width), o, d, check,
            3 * levels)


def case(name) -> Case:
    fmax = lambda n: np.full(n, FLT_MAX, np.float32)
    if name in ("tie_adjacent", "tie_across_lanes"):
        # slots 5 and 6: neighbouring lanes of a group; 5 and 10: the
        # later slot in a lower lane of a group of 8 (10 = 2 mod 8)
        slots = (5, 6) if name == "tie_adjacent" else (5, 10)
        tr, o, d, check = _leaf_tie(slots)
        return Case(o, d, fmax(len(o)), tr, None, None, check)
    if name == "equal_entry":
        # slots 1 and 2 hold identical boxes over leaves with the same
        # triangle (clusters 1 and 0): slot order puts slot 1's first,
        # and its hit is not beaten by the tie behind it
        width = 8
        tris = [OFF, UNIT, OFF, UNIT]
        b = box(tris)
        nodes = [node([None, b, b, None], [0, -2, -1, 0])]
        o, d = down_rays(48, 5.0, seed=3)

        def check(t, tri, occ, cnt):
            assert (tri == 1 * width + 1).all() and (t == 5.0).all()
            assert (cnt[0] == 1).all() and (cnt[2] == 2).all()
            assert (cnt[3] == 1).all()
        tr = tree(nodes, [(2, 2), (0, 2)], 1, tris, width)
        return Case(o, d, fmax(len(o)), tr, None, None, check)
    if name in ("hit_children", "hit_children_empty_refs",
                "empty_refs_live_boxes"):
        tr, o, d, check = _hit_children(name != "hit_children",
                                        name == "empty_refs_live_boxes")
        return Case(o, d, fmax(len(o)), tr, None, None, check)
    if name == "t_max_cuts_leaf":
        # one leaf: BELOW at slot 1 (t = 8), UNIT at slot 3 (t = 5); t_max
        # 4.5 misses both, 6 takes UNIT, 8 (not < 8) UNIT, 9 UNIT
        width = 8
        tris = [OFF, BELOW, OFF, UNIT, OFF]
        nodes = [node([box(tris), None, None, None], [-1, 0, 0, 0])]
        o, d = down_rays(32, 5.0, seed=4)
        tm = np.resize(np.array([4.5, 6.0, 8.0, 9.0], np.float32), 32)

        def check(t, tri, occ, cnt):
            short = tm < 5.0
            assert (tri[short] == -1).all() and (t[short] == tm[short]).all()
            assert (tri[~short] == 3).all() and (t[~short] == 5.0).all()
            assert (occ == ~short).all()
        tr = tree(nodes, [(0, len(tris))], 1, tris, width)
        return Case(o, d, tm, tr, None, None, check)
    if name == "stack_exact":
        tr, o, d, check, need = _stack_exact()
        return Case(o, d, fmax(len(o)), tr, None, need, check)
    if name == "dead_lanes":
        o, d = soup_rays(600, seed=5)
        tm = np.resize(np.array([-1.0, 0.0, np.nan, FLT_MAX, 9.0],
                                np.float32), 600)

        def check(t, tri, occ, cnt):
            dead = ~(tm > 0)
            assert (tri[dead] == -1).all() and not occ[dead].any()
            assert (cnt[:, dead] == 0).all()
            np.testing.assert_array_equal(t[dead], tm[dead])
            assert (tri[~dead] >= 0).sum() > 20
        return Case(o, d, tm, None, dict(t=2000, seed=6, width=32,
                                         quant=False), None, check)
    if name.startswith("soup_"):
        width = int(name.split("_")[1][1:])
        o, d = soup_rays(400, seed=7)

        def check(t, tri, occ, cnt):
            assert (tri >= 0).sum() > 50 and (tri < 0).sum() > 10
            assert (occ == (tri >= 0)).all()
        return Case(o, d, fmax(len(o)), None,
                    dict(t=3000, seed=8, width=width,
                         quant=name.endswith("quant")), None, check)
    raise KeyError(name)
