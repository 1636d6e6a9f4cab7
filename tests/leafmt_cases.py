"""The leaf test's tie cases of K14 (``csrc/leafmt_probe.cu``), as numpy
inputs in the TPU probe's layout, and a NumPy model of the kernel's split:
shared by the CPU tests (``test_torch_probes_leaf.py``: the model and the
JAX kernel in interpret mode against the plain version) and the card's
tests (``test_torch_cuda.py``: the kernel against the plain version).
Imports no JAX.

The kernel tests a visit by the warp: L lanes a (ray, cluster) pair, lane
s testing slots s, s + L, ... against its own running best, the lanes'
(t, slot) merged by a shuffle tree. The cases are where that can break:
  * ``ties``: equal t at two slots, in two lanes (slots 3 and 20; 47 and
    62) and in one lane (3 and 35 at L = 8, 16 and 32): the lower slot
    wins; the rays aim at those triangles;
  * ``zero_nan``: zero rows (a = 0: parallel) and NaN rows (all twelve
    words, or the normal alone) at the slots the rays aim at: no hit
    there; some rays dead (t_max -1) or short (t_max 0.5);
  * ``repeat``: two identical clusters, so in every mode a later visit's
    t equals closest and the first visit's slot stays.
Each case is one 1024-ray tile (the TPU's (8, 128)) with 2 clusters.
"""

import numpy as np

CASES = ["ties", "zero_nan", "repeat"]
TILE = 1024
WIDTH = 64
T_MIN = np.float32(1e-3)
DUPLICATES = {20: 3, 35: 3, 62: 47}  # slot: the slot it copies
ZERO = (8, 9, 10, 11)
NAN = (40, 41, 42)
NAN_NORMAL = 50


def _triangles(rng, C):
    v0 = rng.uniform(-5, 5, (C, WIDTH, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (C, WIDTH, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (C, WIDTH, 3)).astype(np.float32)
    return v0, e1, e2


def _blocks(v0, e1, e2, n):
    """The TPU probe's (C, 16, 128) layout of [C, 64, 3] components."""
    blocks = np.zeros((v0.shape[0], 16, 128), np.float32)
    for r, comp in enumerate((v0, e1, e2, n)):
        blocks[:, 3 * r:3 * r + 3, :WIDTH] = comp.transpose(0, 2, 1)
    return blocks


def _aimed(rng, v0, e1, e2, slots):
    """Rays from 6 units away toward a point inside each of ``slots``'
    triangle (of cluster 0), one ray a slot in turn, within ~30 degrees of
    its normal (from either side, so no ray grazes its triangle); unit
    directions."""
    s = np.resize(np.asarray(slots), TILE)
    a, b = rng.uniform(0.1, 0.4, (2, TILE)).astype(np.float32)
    p = v0[0, s] + a[:, None] * e1[0, s] + b[:, None] * e2[0, s]
    n = np.cross(e1[0, s], e2[0, s])
    side = rng.choice([-1.0, 1.0], (TILE, 1))
    r = rng.randn(TILE, 3)
    d = (side * n / np.linalg.norm(n, axis=1, keepdims=True)
         + 0.5 * r / np.linalg.norm(r, axis=1, keepdims=True))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = (p - 6 * d).astype(np.float32)
    return o.T.copy(), d.T.copy()


def case(name, seed=11):
    """(blocks (2, 16, 128) f32, origins [3, 1024], directions [3, 1024],
    t_max [1024])."""
    rng = np.random.RandomState(seed)
    v0, e1, e2 = _triangles(rng, 2)
    if name == "repeat":
        v0[1], e1[1], e2[1] = v0[0], e1[0], e2[0]
    for dst, src in DUPLICATES.items():
        for comp in (v0, e1, e2):
            comp[:, dst] = comp[:, src]
    n = np.cross(e1, e2)
    tmax = np.full(TILE, 3.4e38, np.float32)
    aim = [3, 20, 35, 47, 62, 5, 17]
    if name == "zero_nan":
        aim = [*ZERO, *NAN, NAN_NORMAL, 20, 3]
    o, d = _aimed(rng, v0, e1, e2, aim)
    if name == "zero_nan":
        for comp in (v0, e1, e2, n):
            comp[:, list(ZERO)] = 0.0
            comp[:, list(NAN)] = np.nan
        n[:, NAN_NORMAL] = np.nan
        tmax[::7] = -1.0
        tmax[3::7] = 0.5
    elif name not in CASES:
        raise KeyError(name)
    return _blocks(v0, e1, e2, n), o, d, tmax


def mt_slots(rows, o, d):
    """(t [N, 64], ok [N, 64]) of ``pt::mt_hit`` without its t < t_best
    test, in the plain version's operation order (``cuda_bvh.mt_rows``),
    in float32: rows [64, 12], o and d [N, 3]."""
    v0x, v0y, v0z, g1x, g1y, g1z, g2x, g2y, g2z, n1, n2, n3 = rows.T
    o1, o2, o3 = (c[:, None] for c in o.T)
    d1, d2, d3 = (c[:, None] for c in d.T)
    with np.errstate(all="ignore"):
        a = -(d1 * n1 + d2 * n2 + d3 * n3)
        parallel = np.abs(a) < np.float32(1e-7)
        f = np.float32(1.0) / a
        sx, sy, sz = o1 - v0x, o2 - v0y, o3 - v0z
        qx = sy * d3 - sz * d2
        qy = sz * d1 - sx * d3
        qz = sx * d2 - sy * d1
        u = f * (qx * g2x + qy * g2y + qz * g2z)
        v = -(f * (qx * g1x + qy * g1y + qz * g1z))
        t = f * (sx * n1 + sy * n2 + sz * n3)
        bad = (parallel | (np.minimum(u, v) < 0) | (u + v > 1)
               | ~(t > T_MIN))
    return t, ~bad


def split_model(o, d, tmax, clusters, visits, staged_once, lanes, skip=0):
    """(closest [N], besti [N]) of the kernel's split: each visit's 64
    slots dealt to ``lanes`` lanes a ray (lane s: slots s, s + lanes, ...
    in order, strict-less against its own running best from the entry
    closest), then the lanes' (t, slot) merged at xor offsets 1, 2, 4, ...
    as ``__shfl_xor_sync`` does (a lane without a slot never wins; an
    equal t takes the lower slot), the ray taking lane 0's. o, d [N, 3];
    clusters [C, 64, 12]; ``staged_once``: every visit tests cluster 0
    (pure, cond), else visit i tests i % C. A ray runs a visit unless
    besti < skip - 1 (the cond mode's branch; never at skip = 0)."""
    closest = tmax.astype(np.float32).copy()
    besti = np.full(len(closest), -1, np.int64)
    lane = np.arange(lanes)
    for i in range(visits):
        run = ~(besti < skip - 1)
        t, ok = mt_slots(clusters[0 if staged_once else i % len(clusters)],
                         o, d)
        tb = np.repeat(closest[:, None], lanes, axis=1)
        kb = np.full(tb.shape, -1, np.int64)
        for k in range(WIDTH):
            s = k % lanes
            take = ok[:, k] & (t[:, k] < tb[:, s])
            tb[:, s] = np.where(take, t[:, k], tb[:, s])
            kb[:, s] = np.where(take, k, kb[:, s])
        off = 1
        while off < lanes:
            t2, k2 = tb[:, lane ^ off], kb[:, lane ^ off]
            take = (k2 >= 0) & ((kb < 0) | (t2 < tb) | ((t2 == tb)
                                                      & (k2 < kb)))
            tb, kb = np.where(take, t2, tb), np.where(take, k2, kb)
            off <<= 1
        win = run & (kb[:, 0] >= 0)
        closest = np.where(win, tb[:, 0], closest)
        besti = np.where(win, i * WIDTH + kb[:, 0], besti)
    return closest, besti.astype(np.int32)
