"""The sphere kernel's contract cases, as numpy inputs: shared by the CPU
tests against the JAX package (``test_torch_spheres.py``) and the card's
tests against the plain version (``test_torch_cuda.py``). Imports no
JAX."""

import numpy as np
import torch

from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

T_MIN = 0.01
# the edge cases of the kernel's contract: first-wins ties (also across
# the residues of a ray's group of lanes), misses, radius <= 0, dead, NaN
# and per-ray t_max, origins inside a sphere, S and N below, off and
# across the kernel's groups and tiles and the plain version's chunks
CASES = ["tie_first_wins", "miss", "nonpositive_radius_never_wins",
         "per_ray_tmax", "ragged_s_130", "s_600_two_chunks",
         "tie_across_residues", "s_1", "s_3", "s_5", "n_1", "n_33", "n_257",
         "dead_lanes", "nan_t_max", "all_dead",
         "nonpositive_first_and_last", "s_1100_two_tiles", "origin_inside"]


def rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def spheres(s, seed):
    rng = np.random.RandomState(seed)
    c = rng.uniform(-10, 10, (s, 3)).astype(np.float32)
    r = rng.uniform(0.4, 2.0, s).astype(np.float32)
    feat = rng.uniform(-3, 3, (s, 18)).astype(np.float32)
    return c, r, feat


def tv3(a):
    """A [N, 3] numpy array as a V3 of CPU tensors."""
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                for k in range(3)))


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _down(n, seed, x0=0.0, spread=0.3):
    """n rays from z = 5 straight down, within ``spread`` of (x0, 0)."""
    rng = np.random.RandomState(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = x0 + rng.uniform(-spread, spread, n)
    o[:, 1] = rng.uniform(-spread, spread, n)
    o[:, 2] = 5.0
    d = np.tile(np.array([0, 0, -1], np.float32), (n, 1))
    return o, d


def _aimed(n, c, seed):
    """n rays from random origins aimed at random centers of ``c``."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    tgt = c[rng.randint(0, c.shape[0], n)]
    return o, _unit(tgt - o)


def case(name):
    """(origin, direction, centers, radii, t_max, check) for one edge case
    of the kernel's contract; check takes (t, idx, features)."""
    if name == "tie_first_wins":
        o = np.array([[0, 0, 5], [0.1, 0, 5]], np.float32)
        d = np.array([[0, 0, -1], [0, 0, -1]], np.float32)
        c = np.array([[5, 5, 5], [0, 0, 0], [0, 0, 0], [0, 0, -3]],
                     np.float32)
        r = np.array([1.0, 1.0, 1.0, 1.0], np.float32)

        def check(t):
            assert (t[1] == 1).all()  # slots 1 and 2 tie exactly
        return o, d, c, r, None, check
    if name == "miss":
        rng = np.random.RandomState(7)
        o = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
        d = np.concatenate([np.ones((64, 1)),
                            rng.uniform(-0.2, 0.2, (64, 2))], axis=1)
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        # every ray heads to +x, every sphere lies at x < -5
        c = rng.uniform(-3, 3, (8, 3)).astype(np.float32)
        c[:, 0] -= 8.0
        r = np.full(8, 0.5, np.float32)

        def check(t):
            assert (t[1] == -1).all()
            assert (t[0] == np.float32(FLT_MAX)).all()
            assert (t[2] == 0).all()
        return o, d, c, r, None, check
    if name == "nonpositive_radius_never_wins":
        o, d = rays(256, seed=8)
        # slots 0-5 sit 0.25 off rays 0-5 at distance 4, where a sphere
        # of radius >= 0.25 would be hit; slots 6-11 (radius 1) sit on
        # the same rays at distance 6
        side = np.cross(d[:6], np.array([0.0, 0.0, 1.0], np.float32))
        side /= np.linalg.norm(side, axis=1, keepdims=True)
        c = np.concatenate([o[:6] + 4.0 * d[:6] + 0.25 * side,
                            o[:6] + 6.0 * d[:6]]).astype(np.float32)
        r = np.array([-1.0, 0.0, -2.0, 0.0, -0.5, -0.3]
                     + [1.0] * 6, np.float32)

        def check(t):
            assert not np.isin(t[1], np.arange(6)).any()
            assert (t[1][:6] >= 6).all()  # the live sphere behind wins
        return o, d, c, r, None, check
    if name == "per_ray_tmax":
        o, d = rays(256, seed=9)
        c, r, _ = spheres(30, seed=10)
        t0, i0 = cs.spheres_hit_soa(tv3(o), tv3(d), tv3(c),
                                    torch.from_numpy(r), T_MIN, FLT_MAX)
        hit0 = i0.numpy() >= 0
        tm = np.where(hit0, t0.numpy() * 0.5, 1e38).astype(np.float32)

        def check(t):
            # nothing before half the nearest hit; t is FLT_MAX, not t_max
            assert (t[1][hit0] == -1).all()
            assert (t[0][hit0] == np.float32(FLT_MAX)).all()
            assert hit0.sum() > 20
        return o, d, c, r, tm, check
    if name in ("ragged_s_130", "s_600_two_chunks"):
        s = 130 if name == "ragged_s_130" else 600
        o, d = rays(256, seed=11)
        c, r, _ = spheres(s, seed=12)
        c = c * 2.0  # spread the larger set out

        def check(t):
            assert (t[1] >= 0).sum() > 50
            if s > cs.S_CHUNK:
                assert (t[1] >= cs.S_CHUNK).any()
        return o, d, c, r, None, check
    if name == "tie_across_residues":
        # three copies of one sphere pair, each in front of its own rays:
        # slots 5 and 6 (neighbouring lanes of a group), 3 and 11 (one
        # lane's slots at 8 lanes a ray, two lanes' at 16) and 7 and 9
        # (the later slot in the lower lane at 4 and 8 lanes a ray); the
        # other slots lie off the rays
        o, d = (np.concatenate(a) for a in zip(
            *(_down(24, 30 + k, x0=20.0 * k) for k in range(3))))
        c = np.stack([100.0 + 3.0 * np.arange(24), np.full(24, 100.0),
                      np.zeros(24)], axis=1).astype(np.float32)
        r = np.full(24, 0.5, np.float32)
        for k, pair in enumerate(((5, 6), (3, 11), (7, 9))):
            c[list(pair)] = (20.0 * k, 0.0, 0.0)
            r[list(pair)] = 1.0

        def check(t):
            np.testing.assert_array_equal(t[1], np.repeat([5, 3, 7], 24))
        return o, d, c, r, None, check
    if name.startswith("s_") and name[2:].isdigit():
        # S below a group's lanes, and not a multiple of them
        s = int(name[2:])
        rng = np.random.RandomState(40 + s)
        c = rng.uniform(-4, 4, (s, 3)).astype(np.float32)
        r = rng.uniform(1.5, 3.0, s).astype(np.float32)
        o = rng.uniform(-12, 12, (128, 3)).astype(np.float32)
        d = _unit(rng.uniform(-6, 6, (128, 3)).astype(np.float32) - o)

        def check(t):
            assert (t[1] == s - 1).any() and (t[1] == -1).any()
        return o, d, c, r, None, check
    if name.startswith("n_"):
        # N of one ray, and not a multiple of a group or a warp
        n_r = int(name[2:])
        c, r, _ = spheres(40, seed=45)
        o, d = _aimed(n_r, c, seed=46 + n_r)

        def check(t):
            assert t[1].shape == (n_r,) and (t[1] >= 0).all()
        return o, d, c, r, None, check
    if name in ("dead_lanes", "nan_t_max", "all_dead"):
        c, r, _ = spheres(50, seed=50)
        o, d = _aimed(96, c, seed=51)
        tm = np.full(96, FLT_MAX, np.float32)
        off = slice(None) if name == "all_dead" else slice(None, None, 3)
        tm[off] = np.nan if name == "nan_t_max" else -1.0
        if name == "dead_lanes":
            tm[1::3] = T_MIN  # t_max = t_min: dead too

        def check(t):
            dead = ~(tm > T_MIN)
            assert (t[1][dead] == -1).all()
            assert (t[0][dead] == np.float32(FLT_MAX)).all()
            assert (t[2][dead] == 0).all()
            assert (t[1][~dead] >= 0).all()
        return o, d, c, r, tm, check
    if name == "nonpositive_first_and_last":
        # radius <= 0 at the first and the last slot, in front of a
        # sphere every ray hits (slots 1-7, one sphere: slot 1 wins)
        o, d = _down(32, 52)
        c = np.zeros((9, 3), np.float32)
        c[[0, 8], 2] = 2.5
        r = np.full(9, 1.0, np.float32)
        r[0], r[8] = -1.0, 0.0

        def check(t):
            assert (t[1] == 1).all()
        return o, d, c, r, None, check
    if name == "s_1100_two_tiles":
        # more spheres than one shared-memory tile of the kernel (1024)
        # and three chunks of the plain version; winners in the last
        # tile
        c, r, _ = spheres(1100, seed=53)
        c = c * 3.0
        o, d = _aimed(128, c[1024:], seed=54)

        def check(t):
            assert (t[1] >= 1024).sum() > 40
            assert (t[1] < 1024).any()
        return o, d, c, r, None, check
    if name == "origin_inside":
        # rays from inside slot 0 (radius 3), and from points on its
        # surface heading in (the near root ~0 <= t_min: a bounce ray's
        # case), so the far root wins; slots 1-7 lie outside it
        rng = np.random.RandomState(55)
        inside = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
        d_in = _unit(rng.normal(size=(64, 3)).astype(np.float32))
        nrm = _unit(rng.normal(size=(64, 3)).astype(np.float32))
        surf = (3.0 * nrm).astype(np.float32)
        d_s = _unit(-nrm + 0.3 * rng.normal(size=(64, 3)).astype(
            np.float32))
        o, d = np.concatenate([inside, surf]), np.concatenate([d_in, d_s])
        c = np.concatenate([np.zeros((1, 3)), rng.uniform(
            -4, 4, (7, 3)) + 12.0]).astype(np.float32)
        r = np.concatenate([[3.0], rng.uniform(0.5, 1.5, 7)]).astype(
            np.float32)

        def check(t):
            assert (t[1] == 0).all()
            assert (t[0] > T_MIN).all() and (t[0] <= 6.0 + 1e-4).all()
        return o, d, c, r, None, check
    raise KeyError(name)
