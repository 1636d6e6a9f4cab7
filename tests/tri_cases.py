"""The triangle kernel's contract cases, as numpy inputs: shared by the
CPU tests against the JAX package (``test_torch_tris.py``) and the card's
tests against the plain version (``test_torch_cuda.py``). Imports no
JAX."""

import numpy as np

from tpu_pathtracer_torch.ops import cuda_tris as ct
from tpu_pathtracer_torch.ops.vec import FLT_MAX

T_MIN = 0.01
# the edge cases of the kernel's contract: first-wins ties (also across
# the residues of a ray's group of lanes), sentinels, dead, NaN and live
# t_max, parallel rays, T and N below, off and across the kernel's
# groups and tiles
CASES = ["tie_first_wins", "sentinel_padding_never_wins", "dead_lanes",
         "parallel_rays_miss", "three_chunks", "tie_across_residues",
         "t_1", "t_3", "t_5", "n_1", "n_33", "n_257", "all_dead",
         "nan_t_max", "sentinel_first_and_last"]


def rays(n, seed, spread=12.0):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.uniform(-8, 8, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def prep(v0, v1, v2):
    """(v0, e1, e2, n) as the engines' views build them (component-wise
    float32 differences and cross products)."""
    with np.errstate(invalid="ignore"):
        e1 = v1 - v0
        e2 = v2 - v0
        n = np.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                      e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                      e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], axis=1)
    return v0, e1, e2, n.astype(np.float32)


def case(name):
    """(origin, direction, v0, v1, v2, t_max, check) for one edge case of
    the kernel's contract."""
    if name == "tie_first_wins":
        o = np.array([[0.2, 0.2, 5], [0.3, 0.1, 5]], np.float32)
        d = np.array([[0, 0, -1], [0, 0, -1]], np.float32)
        tri = np.array([[[5, 5, 5], [6, 5, 5], [5, 6, 5]],
                        [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                        [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                        [[0, 0, -3], [1, 0, -3], [0, 1, -3]]], np.float32)

        def check(t):
            assert (t[1] == 1).all()  # slots 1 and 2 tie exactly
        return o, d, tri, None, check
    if name == "sentinel_padding_never_wins":
        o, d = rays(256, seed=8)
        rng = np.random.RandomState(9)
        tri = rng.uniform(-8, 8, (40, 3, 3)).astype(np.float32)
        tri[::3] = np.inf

        def check(t):
            assert not np.isin(t[1], np.arange(0, 40, 3)).any()
            assert (t[1] >= 0).sum() > 10
        return o, d, tri, None, check
    if name == "dead_lanes":
        o, d = rays(256, seed=10)
        tri = np.random.RandomState(11).uniform(
            -8, 8, (60, 3, 3)).astype(np.float32)
        tm = np.full(256, FLT_MAX, np.float32)
        tm[1::2] = -1.0

        def check(t):
            assert (t[1][1::2] == -1).all()
            assert (t[1][0::2] >= 0).sum() > 10
        return o, d, tri, tm, check
    if name == "parallel_rays_miss":
        o = np.array([[0.2, 5.0, 0.2], [0.1, -3.0, 0.3]], np.float32)
        d = np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
        # slot 0 lies across both rays in the plane y = 0; slot 1 is a
        # wall in the plane x = 0.2, parallel to both (d·n = 0)
        tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 0, 1]],
                        [[0.2, -5, 0], [0.2, 5, 0], [0.2, 0, 1]]],
                       np.float32)

        def check(t):
            assert (t[1] == 0).all()  # never the parallel wall
        return o, d, tri, None, check
    if name == "three_chunks":
        o, d = rays(128, seed=12, spread=20.0)
        rng = np.random.RandomState(13)
        v0 = rng.uniform(-16, 16, (700, 3)).astype(np.float32)
        tri = np.stack([v0, v0 + rng.uniform(-2, 2, (700, 3)),
                        v0 + rng.uniform(-2, 2, (700, 3))],
                       axis=1).astype(np.float32)

        def check(t):
            assert (t[1] >= 2 * ct.T_CHUNK).any()
        return o, d, tri, None, check
    if name == "tie_across_residues":
        # slots 5 and 10 are one triangle (residues 1 and 2 mod 4, 5 and
        # 2 mod 8: the kernel's lanes of one group hold them, the later
        # slot in the lower lane), as are 1 and 12 behind them; the other
        # slots lie off the rays
        o, d = rays(64, seed=21, spread=0.4)
        o[:, 2], d[:] = 5.0, (0.0, 0.0, -1.0)
        o[:, :2] += 0.5
        tri = np.tile(np.array([[50, 50, 0], [51, 50, 0], [50, 51, 0]],
                               np.float32), (16, 1, 1))
        tri[[5, 10]] = [[0, 0, 0], [2, 0, 0], [0, 2, 0]]
        tri[[1, 12]] = [[0, 0, -3], [2, 0, -3], [0, 2, -3]]

        def check(t):
            assert (t[1] == 5).all()
        return o, d, tri, None, check
    if name.startswith("t_"):
        # T below a group's lanes, and not a multiple of them
        n_t = int(name[2:])
        o, d = rays(128, seed=22 + n_t, spread=6.0)
        rng = np.random.RandomState(23 + n_t)
        v0 = rng.uniform(-4, 4, (n_t, 3)).astype(np.float32)
        tri = np.stack([v0, v0 + rng.uniform(-9, 9, (n_t, 3)),
                        v0 + rng.uniform(-9, 9, (n_t, 3))],
                       axis=1).astype(np.float32)

        def check(t):
            assert (t[1] == n_t - 1).any() and (t[1] == -1).any()
        return o, d, tri, None, check
    if name.startswith("n_"):
        # N of one ray, and not a multiple of a group or a warp
        n_r = int(name[2:])
        o, d = rays(n_r, seed=24 + n_r, spread=6.0)
        rng = np.random.RandomState(25)
        v0 = rng.uniform(-4, 4, (40, 3)).astype(np.float32)
        tri = np.stack([v0, v0 + rng.uniform(-6, 6, (40, 3)),
                        v0 + rng.uniform(-6, 6, (40, 3))],
                       axis=1).astype(np.float32)

        def check(t):
            assert t[1].shape == (n_r,) and (t[1] >= 0).any()
        return o, d, tri, None, check
    if name in ("all_dead", "nan_t_max"):
        o, d = rays(96, seed=26, spread=6.0)
        tri = np.random.RandomState(27).uniform(
            -6, 6, (30, 3, 3)).astype(np.float32)
        if name == "all_dead":
            tm = np.full(96, -1.0, np.float32)
        else:
            tm = np.full(96, FLT_MAX, np.float32)
            tm[::3] = np.nan

        def check(t):
            off = slice(None) if name == "all_dead" else slice(None, None, 3)
            assert (t[1][off] == -1).all()
            if name == "nan_t_max":
                assert (t[1] >= 0).any()
        return o, d, tri, tm, check
    if name == "sentinel_first_and_last":
        # +inf sentinels at the first and the last slot, in front of a
        # triangle every ray hits
        o, d = rays(32, seed=28, spread=0.4)
        o[:, 2], d[:] = 5.0, (0.0, 0.0, -1.0)
        o[:, :2] += 0.5
        tri = np.tile(np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]],
                               np.float32), (9, 1, 1))
        tri[[0, 8]] = np.inf

        def check(t):
            assert (t[1] == 1).all()
        return o, d, tri, None, check
    raise KeyError(name)
