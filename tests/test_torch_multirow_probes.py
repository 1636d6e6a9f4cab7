"""The 8-row packet probes of the port (``tpu_pathtracer_torch/
experiments``): K22's leaf round (``leafround_probe``), K23's node step
(``multirow_probe``) and K24's node step from per-component tables
(``gather_probe``), their plain versions against the JAX probes' TPU
kernels in interpret mode (``experiments/leafround_probe.py``,
``multirow_probe.py`` and ``gather_probe.py``, each ``_kernel`` through
its ``run``), on the TPU files' own seeded inputs and on the edge cases
of ``tests/multirow_cases.py`` (K22: the chain's two branches, a tie
across a split's lanes, a = 0 and |a| < 1e-7 in a mode-2 cluster, t =
0.001 exactly, a NaN origin, 0 and 1 rounds, at w = 32 and 64; the walks:
all 128 lanes in both boxes with the right nearer and with the left
nearer, the packed vote's extremes, pref = 0, a pop, one child on each
side, the bitstack passing 0xFFFF and falling to 0, the smallest tables,
K23 N = 32 and K24 S = 8).

The three TPU files run their probe at import and read ``sys.argv`` there,
so only their functions are compiled from the source, into a namespace
that holds the module globals the kernels read (``MODE``, ``C``, ``N``,
``ntab``, ``rays``) and a ``pl`` whose ``pallas_call`` runs in interpret
mode; ``run`` then calls the file's own ``pallas_call`` with its own specs.

Finding ROADMAP C-19: the walks' acc counts misses only (a miss adds 1e30
and swallows every hit's t in float32), so each walk is also held on its
trajectory: the JAX kernel runs with its ``fori_loop`` wrapped to write
each step's idx and bs of every row into the first lanes of its output
(exact: they are below 2^24); acc is held on the other lanes. K22's loop
is wrapped the same way to give each round's ids and lane 0's closest.
The lanes follow the loop's step count, an input of the kernel, so one
compile of a probe serves every count: K22's namespaces are kept by mode
and rays (``_leafround_ns``), which every edge case shares but the seeded
0 and 1 rounds.

Tolerances. K23 and K24: the same float32 operations in the same order
(no multiply-add to contract), so acc and the trajectories are exact. K22:
XLA contracts the Moller-Trumbore multiply-adds into FMAs (ROADMAP C-2),
which moves t by up to 6.4e-6 relative on these inputs (t cancels), so t
is held at rtol 1e-5 on the same lanes hit; a row's next cluster follows
the last bit of lane 0's t, so a row whose chain parts from JAX's must
part where that t differs. Modes 0 and 1 read a cluster scratch that
nothing writes (ROADMAP C-18), and every lane misses on both sides. The
edge cases' constructed rays and triangles use exact arithmetic, so their
t is held exactly, and so is each case's point: the chain's parity
(chain_bits), the tied t (tie), no hit on the parallel triangles' row
(parallel), 0.002 and not 0.001 (t_min), 1e30 on the NaN lanes
(nan_origin), the bitstack's edges (votes). The CUDA kernels run only on a
card: ``tests/test_torch_cuda.py`` holds them bit for bit against these
plain versions, on the same cases in every mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import multirow_cases as mc
from test_torch_probes_walk import _kernel_defs
from tpu_pathtracer_torch.experiments import gather_probe as gp
from tpu_pathtracer_torch.experiments import leafround_probe as lr
from tpu_pathtracer_torch.experiments import multirow_probe as mr
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 5          # node steps of K23 and K24
ROUNDS = 3         # leaf rounds of K22
T_RTOL = 1e-5
FAR = np.float32(mr.FAR)


class _Over:
    """``mod`` with some attributes replaced."""

    def __init__(self, mod, **over):
        self._mod, self._over = mod, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(
            self._mod, name)


def _traced_fori(lo, hi, body, init):
    """A walk's ``fori_loop`` (from 0 to its ``hi`` steps) over its (idx,
    bs, acc) carry that returns, in place of acc, step i's idx (8, 1) in
    lane i and its bs in lane hi + i, and acc in lanes 2 hi to 127."""
    lane = jax.lax.broadcasted_iota(jnp.int32, (8, 128), 1)

    def step(i, c):
        carry, tr = c
        carry = body(i, carry)
        tr = jnp.where(lane == i, carry[0].astype(jnp.float32), tr)
        tr = jnp.where(lane == hi + i, carry[1].astype(jnp.float32), tr)
        return carry, tr

    (idx, bs, acc), tr = jax.lax.fori_loop(
        lo, hi, step, (init, jnp.zeros((8, 128), jnp.float32)))
    return idx, bs, jnp.where(lane < 2 * hi, tr, acc)


def _traced_rounds(lo, hi, body, init):
    """K22's ``fori_loop`` (from 0 to its ``hi`` rounds) over its (ids,
    closest) carry that returns, in place of closest, the ids after round
    i in lane i, lane 0's closest after round i in lane hi + i, and
    closest in lanes 2 hi to 127."""
    lane = jax.lax.broadcasted_iota(jnp.int32, (8, 128), 1)

    def step(i, c):
        carry, tr = c
        ids, cl = body(i, carry)
        tr = jnp.where(lane == i, ids.astype(jnp.float32), tr)
        tr = jnp.where(lane == hi + i, cl[:, :1], tr)
        return (ids, cl), tr

    (ids, cl), tr = jax.lax.fori_loop(
        lo, hi, step, (init, jnp.zeros((8, 128), jnp.float32)))
    return ids, jnp.where(lane < 2 * hi, tr, cl)


def _namespace(traced=None, **glob):
    """The globals of a TPU file's functions: ``pallas_call`` in interpret
    mode, and ``fori_loop`` replaced by ``traced`` if given."""
    jx = jax if traced is None else _Over(
        jax, lax=_Over(jax.lax, fori_loop=traced))
    return dict(jax=jx, jnp=jnp, np=np, functools=functools, pltpu=pltpu,
                pl=_Over(pl, pallas_call=functools.partial(pl.pallas_call,
                                                           interpret=True)),
                **glob)


def _held(out, port, steps=STEPS):
    """A traced walk's output against the port's (acc, idx, bs): the
    trajectory exact, and acc exact on lanes 2 steps to 127. Returns the
    port's (idx, bs)."""
    out = np.asarray(out)
    acc, idx, bs = (a.numpy() for a in port)
    np.testing.assert_array_equal(out[:, :steps].T.astype(np.int32), idx)
    np.testing.assert_array_equal(out[:, steps:2 * steps].T.astype(np.int32),
                                  bs)
    np.testing.assert_array_equal(out[:, 2 * steps:], acc[:, 2 * steps:])
    return idx, bs


def _bitstack_edges(case, idx, bs):
    """The seeded rows walk somewhere; in ``votes`` rows 0-2 (both
    children every step) reach 0xFFFF and stay there, rows 3-4 (one child
    every step) fall to 0 and restart at 1, row 5 pops every step."""
    if case is None:
        assert len(np.unique(idx)) > 4
    elif case == "votes":
        assert (bs[-4:, :3] == 0xFFFF).all()
        assert (bs[:, 3:5] == 1).any(0).all()
        assert (bs[:, 5] < 0x15 + 1).all()


@pytest.fixture(scope="module")
def multirow():
    return mr.probe_inputs(device="cpu")


# the seeded inputs under their own ids, then each edge case
WALK_K23 = [pytest.param(None, m, id=m) for m in mr.MODES] + [
    pytest.param(c, m, id=f"{c}-{m}") for m in mr.MODES
    for c in mc.WALK_CASES]


@pytest.mark.parametrize("case, mode", WALK_K23)
def test_multirow_matches_jax_kernel(multirow, case, mode):
    if case is None:
        (ntab, rays), steps = multirow, STEPS
    else:
        rays_np, ntab_np, steps = mc.walk_case(case, "K23")
        rays, ntab = torch.from_numpy(rays_np), torch.from_numpy(ntab_np)
    names = ("_vec8", "_ctz8", "_kernel", "run")

    ns = _kernel_defs("multirow_probe", names, _namespace(
        _traced_fori, N=ntab.numel() // 6, ntab=jnp.asarray(ntab.numpy()),
        rays=jnp.asarray(rays.numpy()), _ROWI=None))
    idx, bs = _held(ns["run"](steps, mode),
                    mr.multirow_run(rays, ntab, steps, mode, trace=True),
                    steps)
    if case is None or mode == "assemble":
        _bitstack_edges(case, idx, bs)


@pytest.fixture(scope="module")
def gather():
    return gp.probe_inputs((8, 16), device="cpu")


WALK_K24 = [pytest.param(s, None, id=str(s)) for s in (8, 16)] + [
    pytest.param(None, c, id=c) for c in mc.WALK_CASES]


@pytest.mark.parametrize("s, case", WALK_K24)
def test_gather_matches_jax_kernel(gather, s, case):
    if case is None:
        (rays, tabs), steps = gather, STEPS
        tab = tabs[s]
    else:
        rays_np, tab_np, steps = mc.walk_case(case, "K24")
        rays, tab = torch.from_numpy(rays_np), torch.from_numpy(tab_np)
        s = tab.shape[1] * 8
    names = ("_ctz8v", "_kernel", "run")

    ns = _kernel_defs("gather_probe", names, _namespace(
        _traced_fori, rays=jnp.asarray(rays.numpy())))
    idx, bs = _held(ns["run"](steps, jnp.asarray(tab.numpy()), s),
                    gp.gather_run(rays, tab, steps, "shfl", trace=True),
                    steps)
    _bitstack_edges(case, idx, bs)


def test_votes_case_reaches_the_vote_extremes():
    """The ``votes`` rows' first votes: pref -128 and +128 with every lane
    in both boxes, 0, one child on each side, a pop and a mix."""
    rays, _, _ = mc.walk_case("votes", "K24")
    assert mc.first_votes(rays)[:7] == list(mc.VOTES)


def test_gather_inputs_follow_the_tpu_draw_order(gather):
    """S = 16's table is the second drawn after the rays: the full draw
    (8, 16, 32, 64, 128) starts with the same two."""
    rays, tabs = gather
    rays_all, tabs_all = gp.probe_inputs(device="cpu")
    assert torch.equal(rays, rays_all)
    assert all(torch.equal(tabs[s], tabs_all[s]) for s in (8, 16))


@pytest.fixture(scope="module")
def leafround():
    return lr.probe_inputs((32,), device="cpu")


_LEAFROUND_NS = {}


def _leafround_ns(mode, rays):
    """The JAX K22 probe's namespace in ``mode`` over ``rays`` ((7, 8, 128)
    f32, a module constant of the TPU file), kept by both: its ``run`` is
    jitted on the width, and the rounds are an input, so each (mode, rays,
    w) compiles once."""
    key = (mode, rays.tobytes())
    if key not in _LEAFROUND_NS:
        _LEAFROUND_NS[key] = _kernel_defs(
            "leafround_probe", ("_kernel", "run"), _namespace(
                _traced_rounds, MODE=mode, C=lr.C, rays=jnp.asarray(rays)))
    return _LEAFROUND_NS[key]


# the seeded inputs at w = 32 under their own ids, then each edge case in
# mode 2 at both widths
ROUND_PARAMS = [pytest.param(m, None, 32, id=str(m)) for m in (0, 2)] + [
    pytest.param(2, c, w, id=f"{c}-{w}") for c in mc.ROUND_CASES
    for w in lr.WIDTHS]


@pytest.mark.parametrize("mode, case, w", ROUND_PARAMS)
def test_leafround_matches_jax_kernel(leafround, mode, case, w):
    """Per round, the ids and lane 0's closest of each row, and closest
    after the rounds. A row's chain follows the parity of lane 0's t,
    which XLA's FMAs flip on some rows: each row the two sides walk apart
    must part where lane 0's t differs between them, within T_RTOL; the
    other rows end on the same hits, t within T_RTOL. An edge case also
    holds its point (``_round_case_point``)."""
    if case is None:
        (rays, blocks), rounds = leafround, ROUNDS
        b = blocks[w]
    else:
        rays_np, b_np, rounds = mc.round_case(case, w)
        rays, b = torch.from_numpy(rays_np), torch.from_numpy(b_np)
    ns = _leafround_ns(mode, rays.numpy())
    out = np.asarray(ns["run"](rounds, jnp.asarray(b.numpy()), b.shape[1],
                               w))
    j_ids = out[:, :rounds].T.astype(np.int64)          # [rounds, 8]
    j_l0 = out[:, rounds:2 * rounds].T                  # [rounds, 8]
    trail = []
    lr._leafround_ref(rays, b, rounds + 1, mode, trail)
    p_ids = (torch.stack(trail[1:]).numpy() if rounds else
             np.zeros((0, 8), np.int64))
    p_l0 = np.stack([lr.leafround_run(rays, b, r, mode)[:, 0].numpy()
                     for r in range(1, rounds + 1)] or [np.zeros(8)])
    p_all = lr.leafround_run(rays, b, rounds, mode).numpy()
    same = np.ones(8, bool)
    for k in range(rounds):
        part = same & (j_ids[k] != p_ids[k])
        assert (j_l0[k][part] != p_l0[k][part]).all()
        np.testing.assert_allclose(j_l0[k][same], p_l0[k][same],
                                   rtol=T_RTOL, atol=0)
        same &= ~part
    j, p = out[same, 2 * rounds:], p_all[same, 2 * rounds:]
    np.testing.assert_array_equal(j < FAR, p < FAR)
    np.testing.assert_allclose(p[p < FAR], j[p < FAR], rtol=T_RTOL, atol=0)
    if case is not None:
        _round_case_point(case, rounds, out, p_all, same, (j_ids, j_l0),
                          (p_ids, p_l0))
    elif mode == 2:
        assert same.sum() >= 4 and 0 < (p < FAR).sum() < p.size
    else:
        assert same.all() and (p == FAR).all()  # C-18: all miss


def _round_case_point(case, rounds, out, p, same, jax_trail, port_trail):
    """What a K22 edge case is for, on both sides: (ids, lane 0's t) a
    round of the JAX kernel and of the port, closest after the rounds."""
    (j_ids, j_l0), (p_ids, p_l0) = jax_trail, port_trail
    lanes = np.arange(128) >= 2 * rounds
    if rounds == 0:
        assert (p == FAR).all() and (out[:, lanes] == FAR).all()
    elif case == "chain_bits":
        # lane 0's t after round 0 is exact on both sides, its low bit the
        # chain's branch: row 0 takes + 1, row 1 + 2
        for row, t in ((0, mc.T_EVEN), (1, mc.T_ODD)):
            assert j_l0[0][row] == p_l0[0][row] == t
        assert (j_ids[0][:2] == p_ids[0][:2]).all()
        first = np.array([mc._first(0), mc._first(1)])
        assert (p_ids[0][:2] == (first * 5 + 1 + np.array([0, 1])) & 1023
                ).all()
    elif case == "tie":
        assert j_l0[0][mc.TIE_ROW] == p_l0[0][mc.TIE_ROW] == mc.T_TIE
    elif case == "parallel":
        assert (p[mc.PAR_ROW] == FAR).all() and same[mc.PAR_ROW]
        assert (out[mc.PAR_ROW, lanes] == FAR).all()
    elif case == "t_min":
        assert p[mc.T_MIN_ROW, mc.T_MIN_LANE] == np.float32(2e-3)
        assert out[mc.T_MIN_ROW, mc.T_MIN_LANE] == np.float32(2e-3)
    elif case == "nan_origin":
        for row, lane, _ in mc.NAN_LANES:
            assert p[row, lane] == FAR
        assert (p_l0[:, 6] == FAR).all() and (j_l0[:, 6] == FAR).all()


def test_leafround_mode_1_equals_mode_0(leafround):
    rays, blocks = leafround
    b = blocks[32]
    assert torch.equal(lr.leafround_run(rays, b, ROUNDS, 1),
                       lr.leafround_run(rays, b, ROUNDS, 0))


def test_leafround_walks_its_clusters(leafround):
    """Mode 2's ids advance on lane 0's hits: the rounds visit 8 distinct
    clusters each, as the TPU file's update gives them."""
    rays, blocks = leafround
    trail = []
    lr._leafround_ref(rays, blocks[32], ROUNDS, 2, trail)
    ids = torch.stack(trail)
    assert torch.equal(ids[0], (torch.arange(8) * 37 + 1) & (lr.C - 1))
    assert all(len(set(r.tolist())) == 8 for r in ids)
    assert not torch.equal(ids[1], ids[0])


def test_walk_plain_versions_follow_jax_integers():
    """The advance's integer steps: uint32 shifts wrap, the pop's ctz, and
    the bitstack that falls to 0 restarts at 1."""
    bs = torch.tensor([0x15, 0x8000, 0x10000, 1], dtype=torch.int64)
    m = torch.where(bs > 0, mr._ctz32(bs), 0)
    assert m.tolist() == [0, 15, 16, 0]
    assert (((bs << 1) & 0xFFFFFFFF) & 0xFFFF).tolist() == [0x2A, 0, 0, 2]


@pytest.mark.parametrize("probe", ["multirow", "gather", "leafround"])
def test_wrappers_refuse_bad_arguments(probe):
    rays = torch.zeros((7, 8, 128))
    if probe == "multirow":
        with pytest.raises(ValueError, match="mode"):
            mr.multirow_run(rays, torch.zeros(24), 1, "bogus")
        with pytest.raises(ValueError, match="steps"):
            mr.multirow_run(rays, torch.zeros(24), -1)
    elif probe == "gather":
        with pytest.raises(ValueError, match="mode"):
            gp.gather_run(rays, torch.zeros((12, 1, 8, 128)), 1, "bogus")
    else:
        with pytest.raises(ValueError, match="mode"):
            lr.leafround_run(rays, torch.zeros((1024, 4, 128)), 1, 3)
