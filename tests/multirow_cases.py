"""K22's and K23/K24's edge inputs (``csrc/multirow_probes.cu``
``leafround_kernel`` and ``walk8_kernel``), as numpy arrays: shared by the
CPU tests (``test_torch_multirow_probes.py``: the plain versions against
the TPU kernels in interpret mode) and the card's tests
(``test_torch_cuda.py``, and ``chip_smoke.py`` phase 17: the kernels
against the plain versions). Imports no JAX.

K22 (``round_case(name, w)``: rays (7, 8, 128), blocks (1024, 16 w / 128,
128), rounds), each the TPU file's seeded inputs changed on a few rows.
The constructed triangles and rays use exact arithmetic (products with 0,
1 and powers of two), so their t is the same with and without FMAs, and
sit at x, y = 64, where no seeded triangle reaches. Each constructed case
sets the rays of rows of its own, so the five share one set of rays
(``edge_rays``: every case's constructed rays at once) and differ only in
their blocks, each holding its own case's triangles; the JAX kernel,
which holds the rays as a constant, then compiles once for all five:

  * ``chain_bits``: lane 0 of row 0 hits a triangle of its first cluster
    at t = 0.0625 (the low bit of its bits 0) and lane 0 of row 1 at the
    next float up (low bit 1): both branches of the chain;
  * ``tie``: lane 0 of row 2 meets three copies of one triangle of its
    first cluster, at j = 7, 8 and 24, at t = 0.125, its least: three
    triangles share the least t, on different lanes of every split (8, 16,
    32 lanes a ray, and the producer's 32);
  * ``parallel``: every lane of row 4 from (64.25, 64.25, 0.5) along -z,
    and in its first cluster triangle 0 with n = 0 (a = 0 exactly) and
    triangle 1 with n = (0, 0, 1e-8) (a = 1e-8, |a| < 1e-7), both in the
    plane z = 0 under the lanes: neither is accepted;
  * ``t_min``: lane 11 of row 5 meets a triangle at t = 0.001 exactly
    (excluded by t > 1e-3) and one at 0.002 (accepted);
  * ``nan_origin``: lane 0 of row 6 and lane 9 of row 7 with a NaN
    origin component (never accepted; row 6's chain runs on 1e30);
  * ``zero_rounds`` and ``one_round``: the seeded inputs at 0 and 1
    rounds.

K23/K24 (``walk_case(name, kernel)``: rays (7, 8, 128) and K23's ntab (N
* 6,) or K24's tabs (12, S / 8, 8, 128), steps). ``votes`` gives every
node pair of the smallest table (K23 N = 32, K24 S = 8) the same boxes, L
= [1, 4]^3 and R = [2, 4.5]^3, and each row a family of rays: row 0 from
the origin along (1, 1, 1) (both boxes, the left nearer: pref = -128), row
1 from (5, 5, 5) back (the right nearer: pref = +128), row 2 half and
half (pref = 0, no swap), row 3 only the left box, row 4 only the right,
row 5 neither (a pop every step), row 6 half row 0's, half row 3's, row 7
the seeded rays. Every step of a row is the same vote, so over its 20
steps row 0's and row 1's bitstacks pass 0xFFFF and stay there, and row
3's and row 4's fall to 0 and restart at 1. ``votes_first`` sets those
boxes only at each row's first pair of the TPU files' own tables (K23 N =
4096, K24 S = 16), and ``smallest`` is the seeded inputs at the smallest
tables.
"""

import numpy as np

from tpu_pathtracer_torch.experiments import gather_probe as gp
from tpu_pathtracer_torch.experiments import leafround_probe as lr
from tpu_pathtracer_torch.experiments import multirow_probe as mr

ROUND_CASES = {"chain_bits": 3, "tie": 3, "parallel": 3, "t_min": 3,
               "nan_origin": 3, "zero_rounds": 0, "one_round": 1}
WALK_CASES = ("votes", "votes_first", "smallest")
WALK_STEPS = 20
SMALLEST = {"K23": 32, "K24": 8}       # N, S
DEFAULT = {"K23": mr.N, "K24": 16}

T_EVEN = np.float32(0.0625)
T_ODD = np.nextafter(T_EVEN, np.float32(1))
TIE_ROW, TIE_W, TIE_COPIES = 2, 7, (1, 17)
T_TIE = np.float32(0.125)
PAR_ROW = 4
T_MIN_ROW, T_MIN_LANE = 5, 11
NAN_LANES = ((6, 0, 0), (7, 9, 1))     # (row, lane, component of o)


def _first(row: int) -> int:
    """Row ``row``'s first cluster."""
    return (row * 37 + 1) & (lr.C - 1)


def _set_tri(blocks, c, j, w, words) -> None:
    """Triangle j of cluster c: its 12 words (v0, e1, e2, n)."""
    flat = blocks[c].reshape(-1)
    for k, v in enumerate(words):
        flat[k * w + j] = v


# the constructed rays and triangles sit at x, y = 64, far from the seeded
# triangles (standard normal), which none of them meets
FAR_XY = 64.0


def _down_ray(rays, row, lane, z) -> None:
    """Lane ``lane`` of row ``row`` from (64.25, 64.25, z) along -z."""
    rays[:6, row, lane] = (FAR_XY + 0.25, FAR_XY + 0.25, z, 0.0, 0.0, -1.0)


# a triangle in the plane z = z0 under the down rays: u = v = 0.25, t = z - z0
def _floor_tri(z0):
    return (FAR_XY, FAR_XY, z0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def _lane_ts(rays, blocks, c, row, lane, w):
    """The plain version's accepted t of one lane over cluster c's
    triangles (1e30 where not accepted)."""
    import torch
    from tpu_pathtracer_torch.ops import cuda_bvh as cb
    cl = torch.from_numpy(blocks[c].reshape(-1)[:12 * w].reshape(12, w).T
                          .copy())[None]
    o = torch.from_numpy(rays[:3, row, lane].copy())[None]
    d = torch.from_numpy(rays[3:6, row, lane].copy())[None]
    t, ok = cb.mt_rows(cl, o, d, lr.T_MIN,
                       torch.full((1,), mr.FAR, dtype=torch.float32))
    return np.where(ok[0].numpy(), t[0].numpy(), np.float32(mr.FAR))


def edge_rays(rays) -> None:
    """The constructed cases' rays, set in ``rays`` (the seeded rays):
    lanes 0 of rows 0 and 1 (``chain_bits``) and of row 2 (``tie``), every
    lane of row 4 (``parallel``), lane 11 of row 5 (``t_min``) and the NaN
    origins of rows 6 and 7 (``nan_origin``)."""
    for row, t in ((0, T_EVEN), (1, T_ODD)):
        _down_ray(rays, row, 0, t)
    _down_ray(rays, TIE_ROW, 0, T_TIE)
    for lane in range(mr.LANES):
        _down_ray(rays, PAR_ROW, lane, 0.5)
    _down_ray(rays, T_MIN_ROW, T_MIN_LANE, np.float32(1e-3))
    for row, lane, comp in NAN_LANES:
        rays[comp, row, lane] = np.nan


def round_case(name: str, w: int):
    """(rays (7, 8, 128) f32, blocks (1024, 16 w / 128, 128) f32, rounds)
    of the K22 case ``name`` at width ``w``."""
    rays, blocks = lr.probe_inputs(lr.WIDTHS, "cpu")
    rays, blocks = rays.numpy().copy(), blocks[w].numpy().copy()
    if name not in ROUND_CASES:
        raise ValueError(f"no K22 case {name!r}")
    if name not in ("zero_rounds", "one_round"):
        edge_rays(rays)
    if name == "chain_bits":
        for row, t in ((0, T_EVEN), (1, T_ODD)):
            _set_tri(blocks, _first(row), 5, w, _floor_tri(0.0))
            ts = _lane_ts(rays, blocks, _first(row), row, 0, w)
            assert ts.min() == t and np.argmin(ts) == 5, (row, ts.min())
    elif name == "tie":
        c = _first(TIE_ROW)
        for j in (TIE_W,) + tuple((TIE_W + k) % w for k in TIE_COPIES):
            _set_tri(blocks, c, j, w, _floor_tri(0.0))
        ts = _lane_ts(rays, blocks, c, TIE_ROW, 0, w)
        assert ts.min() == T_TIE and (ts == T_TIE).sum() == 3
    elif name == "parallel":
        c = _first(PAR_ROW)
        base = _floor_tri(0.0)
        _set_tri(blocks, c, 0, w, base[:9] + (0.0, 0.0, 0.0))
        _set_tri(blocks, c, 1, w, base[:9] + (0.0, 0.0, 1e-8))
        ts = _lane_ts(rays, blocks, c, PAR_ROW, 0, w)
        assert ts[0] == mr.FAR and ts[1] == mr.FAR
    elif name == "t_min":
        c = _first(T_MIN_ROW)
        _set_tri(blocks, c, 2, w, _floor_tri(0.0))
        _set_tri(blocks, c, 3, w, _floor_tri(-np.float32(1e-3)))
        ts = _lane_ts(rays, blocks, c, T_MIN_ROW, T_MIN_LANE, w)
        assert ts[2] == mr.FAR and ts.min() == ts[3] == np.float32(2e-3)
    return rays, blocks, ROUND_CASES[name]


# the two boxes of ``votes`` (lo xyz, hi xyz each) and the rows' rays
BOX_L = (1.0, 1.0, 1.0, 4.0, 4.0, 4.0)
BOX_R = (2.0, 2.0, 2.0, 4.5, 4.5, 4.5)
FAMILIES = {"both_l": ((0, 0, 0), (1, 1, 1)),
            "both_r": ((5, 5, 5), (-1, -1, -1)),
            "left": ((0, 0, 1.5), (1, 1, 1e-3)),
            "right": ((0, 0, 4.25), (1, 1, 1e-3)),
            "none": ((0, 0, 0), (-1, -1, -1))}
ROW_FAMILIES = (("both_l",), ("both_r",), ("both_l", "both_r"), ("left",),
                ("right",), ("none",), ("both_l", "left"), None)


def _vote_rays(rays) -> None:
    """Rows 0-6 of ``rays`` set to their families (a row of two: lanes
    0-63 the first, 64-127 the second); row 7 kept."""
    for row, fams in enumerate(ROW_FAMILIES):
        if fams is None:
            continue
        half = mr.LANES // len(fams)
        for k, fam in enumerate(fams):
            o, d = FAMILIES[fam]
            lanes = slice(k * half, (k + 1) * half)
            rays[:6, row, lanes] = np.array(o + d, np.float32)[:, None]


# rows 0-6's first vote in ``votes`` (pref, nl, nr): the packed vote's
# extremes, no swap, one child on each side, a pop, and a mix
VOTES = ((-128, 128, 128), (128, 128, 128), (0, 128, 128), (0, 128, 0),
         (0, 0, 128), (0, 0, 0), (-64, 128, 64))


def first_votes(rays) -> list:
    """Each row's (pref, nl, nr) against BOX_L and BOX_R (the plain
    slab test, closest 1e30)."""
    import torch
    r = torch.from_numpy(rays)
    o, inv = r[:3], 1.0 / r[3:6]
    cl = r[6] * 0.0 + mr.FAR
    box = lambda b: torch.tensor(b, dtype=torch.float32)[:, None, None]
    lh, rh = mr.slab(box(BOX_L), o, inv, cl), mr.slab(box(BOX_R), o, inv, cl)
    tl, tr = lh < cl, rh < cl
    pref = torch.where(tl & tr, torch.where(rh < lh, 1, -1), 0).sum(1)
    return [tuple(int(v) for v in x) for x in zip(pref, tl.sum(1),
                                                   tr.sum(1))]


def walk_case(name: str, kernel: str):
    """(rays (7, 8, 128) f32, table, steps) of the walk case ``name`` for
    ``kernel`` ("K23": ntab (N * 6,) f32; "K24": tabs (12, S / 8, 8, 128)
    f32)."""
    if name not in WALK_CASES:
        raise ValueError(f"no walk case {name!r}")
    size = DEFAULT[kernel] if name == "votes_first" else SMALLEST[kernel]
    if kernel == "K23":
        ntab, rays = (a.numpy().copy() for a in mr.probe_inputs(size, "cpu"))
        pairs = ntab.reshape(-1, 12)                    # pair p: row p
        first = np.arange(mr.ROWS) % (size // 2 - 1) + 1
        table = ntab
    else:
        rays, tabs = gp.probe_inputs((size,), "cpu")
        rays, table = rays.numpy().copy(), tabs[size].numpy().copy()
        pairs = table.reshape(12, -1).T                 # a view: pair p
        first = (np.arange(mr.ROWS) * 37 + 1) & (size * 128 - 1)
    if name != "smallest":
        _vote_rays(rays)
        assert first_votes(rays)[:7] == list(VOTES)
        box = np.array(BOX_L + BOX_R, np.float32)
        if name == "votes":
            pairs[:] = box
        else:
            pairs[first] = box
    if kernel == "K23":
        table = pairs.reshape(-1)
    return rays, table, WALK_STEPS
