"""The 8-row packet probes of the port (``tpu_pathtracer_torch/
experiments``): K22's leaf round (``leafround_probe``), K23's node step
(``multirow_probe``) and K24's node step from per-component tables
(``gather_probe``), their plain versions against the JAX probes' TPU
kernels in interpret mode (``experiments/leafround_probe.py``,
``multirow_probe.py`` and ``gather_probe.py``, each ``_kernel`` through
its ``run``), on the TPU files' own seeded inputs.

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

Tolerances. K23 and K24: the same float32 operations in the same order
(no multiply-add to contract), so acc and the trajectories are exact. K22:
XLA contracts the Moller-Trumbore multiply-adds into FMAs (ROADMAP C-2),
which moves t by up to 6.4e-6 relative on these inputs (t cancels), so t
is held at rtol 1e-5 on the same lanes hit; a row's next cluster follows
the last bit of lane 0's t, so a row whose chain parts from JAX's must
part where that t differs. Modes 0 and 1 read a cluster scratch that
nothing writes (ROADMAP C-18), and every lane misses on both sides. The
CUDA kernels run only on a card: ``tests/test_torch_cuda.py`` holds them
bit for bit against these plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from test_torch_probes_walk import _kernel_defs
from tpu_pathtracer_torch.experiments import gather_probe as gp
from tpu_pathtracer_torch.experiments import leafround_probe as lr
from tpu_pathtracer_torch.experiments import multirow_probe as mr

STEPS = 5          # node steps of K23 and K24
ROUNDS = 3         # leaf rounds of K22
T_RTOL = 1e-5


class _Over:
    """``mod`` with some attributes replaced."""

    def __init__(self, mod, **over):
        self._mod, self._over = mod, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(
            self._mod, name)


def _traced_fori(lo, hi, body, init):
    """A walk's ``fori_loop`` over its (idx, bs, acc) carry that returns,
    in place of acc, step i's idx (8, 1) in lane i and its bs in lane
    STEPS + i, and acc in lanes 2 STEPS to 127."""
    lane = jax.lax.broadcasted_iota(jnp.int32, (8, 128), 1)

    def step(i, c):
        carry, tr = c
        carry = body(i, carry)
        tr = jnp.where(lane == i, carry[0].astype(jnp.float32), tr)
        tr = jnp.where(lane == STEPS + i, carry[1].astype(jnp.float32), tr)
        return carry, tr

    (idx, bs, acc), tr = jax.lax.fori_loop(
        lo, hi, step, (init, jnp.zeros((8, 128), jnp.float32)))
    return idx, bs, jnp.where(lane < 2 * STEPS, tr, acc)


def _traced_rounds(lo, hi, body, init):
    """K22's ``fori_loop`` over its (ids, closest) carry that returns, in
    place of closest, the ids after round i in lane i, lane 0's closest
    after round i in lane ROUNDS + i, and closest in lanes 2 ROUNDS to
    127."""
    lane = jax.lax.broadcasted_iota(jnp.int32, (8, 128), 1)

    def step(i, c):
        carry, tr = c
        ids, cl = body(i, carry)
        tr = jnp.where(lane == i, ids.astype(jnp.float32), tr)
        tr = jnp.where(lane == ROUNDS + i, cl[:, :1], tr)
        return (ids, cl), tr

    (ids, cl), tr = jax.lax.fori_loop(
        lo, hi, step, (init, jnp.zeros((8, 128), jnp.float32)))
    return ids, jnp.where(lane < 2 * ROUNDS, tr, cl)


def _namespace(traced=None, **glob):
    """The globals of a TPU file's functions: ``pallas_call`` in interpret
    mode, and ``fori_loop`` replaced by ``traced`` if given."""
    jx = jax if traced is None else _Over(
        jax, lax=_Over(jax.lax, fori_loop=traced))
    return dict(jax=jx, jnp=jnp, np=np, functools=functools, pltpu=pltpu,
                pl=_Over(pl, pallas_call=functools.partial(pl.pallas_call,
                                                           interpret=True)),
                **glob)


def _held(out, port):
    """A traced walk's output against the port's (acc, idx, bs): the
    trajectory exact, and acc exact on lanes 2 STEPS to 127."""
    out = np.asarray(out)
    acc, idx, bs = (a.numpy() for a in port)
    np.testing.assert_array_equal(out[:, :STEPS].T.astype(np.int32), idx)
    np.testing.assert_array_equal(out[:, STEPS:2 * STEPS].T.astype(np.int32),
                                  bs)
    np.testing.assert_array_equal(out[:, 2 * STEPS:], acc[:, 2 * STEPS:])
    assert len(np.unique(idx)) > 4  # the rows walk somewhere


@pytest.fixture(scope="module")
def multirow():
    return mr.probe_inputs(device="cpu")


@pytest.mark.parametrize("mode", mr.MODES)
def test_multirow_matches_jax_kernel(multirow, mode):
    ntab, rays = multirow
    names = ("_vec8", "_ctz8", "_kernel", "run")

    ns = _kernel_defs("multirow_probe", names, _namespace(
        _traced_fori, N=mr.N, ntab=jnp.asarray(ntab.numpy()),
        rays=jnp.asarray(rays.numpy()), _ROWI=None))
    _held(ns["run"](STEPS, mode),
          mr.multirow_run(rays, ntab, STEPS, mode, trace=True))


@pytest.fixture(scope="module")
def gather():
    return gp.probe_inputs((8, 16), device="cpu")


@pytest.mark.parametrize("s", [8, 16])
def test_gather_matches_jax_kernel(gather, s):
    rays, tabs = gather
    names = ("_ctz8v", "_kernel", "run")

    ns = _kernel_defs("gather_probe", names, _namespace(
        _traced_fori, rays=jnp.asarray(rays.numpy())))
    _held(ns["run"](STEPS, jnp.asarray(tabs[s].numpy()), s),
          gp.gather_run(rays, tabs[s], STEPS, "shfl", trace=True))


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


@pytest.mark.parametrize("mode", [0, 2])
def test_leafround_matches_jax_kernel(leafround, mode):
    """Per round, the ids and lane 0's closest of each row, and closest
    after ROUNDS rounds. A row's chain follows the parity of lane 0's t,
    which XLA's FMAs flip on some rows: each row the two sides walk apart
    must part where lane 0's t differs between them, within T_RTOL; the
    other rows end on the same hits, t within T_RTOL."""
    rays, blocks = leafround
    w, b = 32, blocks[32]
    ns = _kernel_defs("leafround_probe", ("_kernel", "run"), _namespace(
        _traced_rounds, MODE=mode, C=lr.C, rays=jnp.asarray(rays.numpy())))
    out = np.asarray(ns["run"](ROUNDS, jnp.asarray(b.numpy()), b.shape[1],
                               w))
    j_ids = out[:, :ROUNDS].T.astype(np.int64)          # [ROUNDS, 8]
    j_l0 = out[:, ROUNDS:2 * ROUNDS].T                  # [ROUNDS, 8]
    trail = []
    lr._leafround_ref(rays, b, ROUNDS + 1, mode, trail)
    p_ids = torch.stack(trail[1:]).numpy()
    p_l0 = np.stack([lr.leafround_run(rays, b, r, mode)[:, 0].numpy()
                     for r in range(1, ROUNDS + 1)])
    p = lr.leafround_run(rays, b, ROUNDS, mode).numpy()
    far = np.float32(mr.FAR)
    same = np.ones(8, bool)
    for k in range(ROUNDS):
        part = same & (j_ids[k] != p_ids[k])
        assert (j_l0[k][part] != p_l0[k][part]).all()
        np.testing.assert_allclose(j_l0[k][same], p_l0[k][same],
                                   rtol=T_RTOL, atol=0)
        same &= ~part
    j, p = out[same, 2 * ROUNDS:], p[same, 2 * ROUNDS:]
    np.testing.assert_array_equal(j < far, p < far)
    if mode == 2:
        assert same.sum() >= 4 and 0 < (p < far).sum() < p.size
        np.testing.assert_allclose(p[p < far], j[p < far], rtol=T_RTOL,
                                   atol=0)
    else:
        assert same.all() and (p == far).all()  # C-18: all miss


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
