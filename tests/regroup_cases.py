"""The regrouped window's merge and tie cases of K21
(``csrc/regroup_probe.cu``), as numpy inputs in the TPU probe's layout:
shared by the CPU tests (``test_torch_regroup_probe.py``: the plain
version against the JAX file's ``numpy_ref`` and its kernel in interpret
mode) and the card's tests (``test_torch_cuda.py``: the kernel at every
``kSlotLanes`` against the plain version). Imports no JAX.

Each case is the seeded window (``make_arrays``, ``default_rng(7)``) with
a few rays and clusters crafted in exact arithmetic: a crafted ray starts
at a point of the z = 0 plane and runs along +z, and a crafted triangle
T(z) lies in the plane z, v0 = (-1, -1, z), e1 = (4, 0, 0), e2 = (0, 4,
0), n = (0, 0, 16). Every product of the test is then exact, so t = z to
the bit on every side, with or without FMAs. A crafted ray's demand is
only what its case gives it, and a crafted visit's other triangles are
zero rows (parallel: never hit). The cases are where the kernel's merge
can break:
  * ``tie_visits``: one ray's two slots at the same t in different visits
    (3 and 40), the later visit holding the lower triangle: the earlier
    slot wins;
  * ``last_visit``: a ray whose only slot is in visit 63;
  * ``empty_between``: visit 20 has no demand between visits 19 and 21,
    which have (they share a vpref); a ray demands 19 and 21;
  * ``every_visit``: a ray demands all 64 visits, its least t at visits
    10 and 63 (the earlier wins), and t = cl0 at visit 0;
  * ``triangle_ties``: triangles 0, 32 and 63 of one cluster at one t
    (triangle 0 wins), and 7 and 56 of another (7 wins, though at 8
    lanes a slot lane 0 holds 56 and lane 7 holds 7);
  * ``cl0_exact``: a ray whose least t is its cl0 exactly (2 = 2: no
    hit, ``hit = minv < clc``), one whose cl0 is the next float up (a hit
    at 2), and one that misses the crafted cluster (cl0 and -1).
``EXPECT[name]`` gives each crafted ray's (t_out, i_out) in mode full.

A ray with cl0 = FLT_MAX is no case: the TPU kernel fetches the rays by a
one-hot product of their 3-term bf16 split, whose high part of FLT_MAX
rounds to inf, and inf x 0 then makes every slot's cl0 NaN, so no slot of
the window hits there (the split is exact below bf16's largest finite
value, ~3.39e38).
"""

import numpy as np
import torch

from tpu_pathtracer_torch.experiments import regroup_probe as rp

CASES = ["tie_visits", "last_visit", "empty_between", "every_visit",
         "triangle_ties", "cl0_exact"]
K, W = rp.K, rp.W
CIDS = {3: 100, 40: 200, 63: 300, 21: 400, 10: 500, 7: 600, 8: 700,
        12: 800}


def _triangle(tri, v, w, z):
    """T(z) as triangle w of visit v's comp-major cluster."""
    c = tri[v].reshape(16, W)
    for comp, val in zip(range(12), (-1, -1, z, 4, 0, 0, 0, 4, 0, 0, 0,
                                     16)):
        c[comp, w] = val


def _ray(rays, masks, r, visits, x=0.0, cl0=None):
    """Ray r from (x, 0, 0) along +z, demanding exactly ``visits``."""
    flat = rays.reshape(7, -1)
    flat[:6, r] = (x, 0, 0, 0, 0, 1)
    if cl0 is not None:
        flat[6, r] = cl0
    m = masks.reshape(K, -1)
    m[:, r] = 0
    m[list(visits), r] = 1


def _base():
    rays, masks, _, cids, tri = rp.make_arrays(np.random.default_rng(7))
    for v, c in CIDS.items():
        cids[v] = c
    return rays, masks, cids, tri


def case(name):
    """(rays (7, 8, 128) f32, masks (64, 8, 128) f32, vpref (65,) int32,
    cids (64,) int32, tri (64, 1024) f32): the seeded window with the
    case's rays and clusters; vpref from the masks' counts."""
    rays, masks, cids, tri = _base()
    crafted = {"tie_visits": (3, 40), "last_visit": (63,),
               "empty_between": (19, 21), "every_visit": range(K),
               "triangle_ties": (7, 8), "cl0_exact": (12,)}[name]
    for v in crafted:
        tri[v, :12 * W] = 0.0
    if name == "tie_visits":
        _triangle(tri, 3, 9, 2.0)
        _triangle(tri, 40, 5, 2.0)
        _ray(rays, masks, 5, (3, 40))
        _ray(rays, masks, 6, (40,))
    elif name == "last_visit":
        _triangle(tri, 63, 17, 3.0)
        _ray(rays, masks, 1000, (63,))
    elif name == "empty_between":
        _triangle(tri, 19, 4, 2.5)
        _triangle(tri, 21, 60, 1.5)
        masks[20] = 0.0
        _ray(rays, masks, 300, (19, 21))
    elif name == "every_visit":
        for v in range(K):
            _triangle(tri, v, v, 4.0625 if v == 10 else 8.0 - v / 16)
        _ray(rays, masks, 777, range(K))
    elif name == "triangle_ties":
        for w in (0, 32, 63):
            _triangle(tri, 7, w, 2.0)
        for w in (7, 56):
            _triangle(tri, 8, w, 1.5)
        _ray(rays, masks, 100, (7,))
        _ray(rays, masks, 101, (8,))
    elif name == "cl0_exact":
        _triangle(tri, 12, 20, 2.0)
        _ray(rays, masks, 200, (12,), cl0=2.0)
        _ray(rays, masks, 201, (12,), cl0=np.nextafter(np.float32(2.0),
                                                      np.float32(3.0)))
        _ray(rays, masks, 202, (12,), x=10.0)
    counts = (masks.reshape(K, -1) > 0.5).sum(1)
    vpref = np.zeros(K + 1, np.int32)
    vpref[1:] = np.cumsum(counts)
    assert vpref[-1] <= rp.S, vpref[-1]
    return rays, masks, vpref, cids, tri


# each crafted ray's (t_out, i_out) in mode full
EXPECT = {
    "tie_visits": {5: (2.0, 100 * W + 9), 6: (2.0, 200 * W + 5)},
    "last_visit": {1000: (3.0, 300 * W + 17)},
    "empty_between": {300: (1.5, 400 * W + 60)},
    "every_visit": {777: (4.0625, 500 * W + 10)},
    "triangle_ties": {100: (2.0, 600 * W), 101: (1.5, 700 * W + 7)},
    "cl0_exact": {200: (2.0, -1), 201: (2.0, 800 * W + 20),
                  202: (8.0, -1)},
}


def inputs(name, device):
    """The case as :func:`regroup_probe.probe_inputs` gives a window:
    rays, masks and tri on ``device``, vpref and cids on the host."""
    rays, masks, vpref, cids, tri = case(name)
    dev = lambda a: torch.from_numpy(a).to(device)
    return {"rays": dev(rays), "masks": dev(masks), "tri": dev(tri),
            "vpref": torch.from_numpy(vpref), "cids": torch.from_numpy(cids)}
