"""The regrouped heap walk of the port (ops/cuda_bvh_rg.py, plain version)
against the JAX package's ``packet_trace_rg``
(``tpu_pathtracer/ops/pallas_bvh_rg.py``, interpret mode) and against the
port's heap walk (``ops/cuda_bvh.py``).

Tolerances. Against the JAX kernel, the checks of its own tests
(``tests/test_packet_rg.py:57-78``, its ``_check``), with its t, u and v
bounds widened to the XLA-contraction bound of
``tests/test_torch_tris.py`` (its rtol 2e-6 holds between two JAX
kernels that both contract multiply-adds into FMAs; PyTorch does not,
and on grazing lanes t moves by up to 5e-6 relative): hit masks equal;
winner ids differ only where both carry the same t
(``assert_ids_or_ties``); the rest as
``test_torch_bvh_mx.assert_hits_match_jax``. Against the port's heap
walk: t bit for bit, winners except exact ties, and leaf visits never
fewer than the heap walk's and at most 1.5x + 4 of them (the bound
``tests/test_packet_rg.py:88-89`` holds the JAX kernel to).

The contract cases (``tests/rg_cases.py``) are held the same two ways, a
case a test, with one difference: on a case built around a tie (a
``window_tie`` lane takes the lower slot of a later-visited leaf where
the heap walk keeps the first visited) winners may differ on every lane,
so each differing lane must carry the same t under both winners, with
no count bound. The JAX kernel takes a case at the case's leaf width
where it would merge the whole tree into one cluster (ROADMAP C-21: with
the root a leaf it returns no hit) and a NaN t_max as -1, which both
walks treat as a dead lane (C-21: one NaN lane drops the hits of other
lanes of its packet); it refuses leaf widths whose 16 x width is no
multiple of 128 (``pallas_bvh_rg.py:77-79``), so the cases of 5 and 33
slots a leaf it cannot build are held against the heap walk alone.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_bvh4 import T_MIN, assert_ids_or_ties, both_meshes, jv, \
    rays, tri_t, tv
from test_torch_bvh_mx import assert_hits_match_jax
from test_torch_heap import _jax_mesh
from test_torch_tris import _tol
from tpu_pathtracer.ops.pallas_bvh_rg import build_packet_rg, packet_trace_rg
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh_rg as crg
from tpu_pathtracer_torch.ops.vec import FLT_MAX
import rg_cases

# the cases whose leaf width build_packet_rg refuses
JAX_REFUSES = ("tie_w5", "tie_w33", "soup_w33")
# the cases whose tree build_packet_rg would merge into one cluster
JAX_WIDTH = {"window_tie": rg_cases.P_STACK,
             "cross_window_tie": rg_cases.P_STACK}


@pytest.mark.parametrize("t,n,seed,dense_thresh", [
    (4000, 2048, 1, 2000),   # all sparse
    (4000, 2048, 3, 40),     # mixed dense/sparse on the TPU
    (512, 2048, 5, 2000),    # few leaves, windows flush on pair count
])
def test_rg_walk_matches_jax_kernel(t, n, seed, dense_thresh):
    jm, tm = both_meshes(t, seed=seed, ppl=64)
    rg = build_packet_rg(jm, max_width=64)
    pm = rg.pm
    o, d = rays(n, seed=seed + 1)
    jouts, _ = packet_trace_rg(
        jv(o), jv(d), FLT_MAX, pm.nodes, pm.blocks, rg.blocks_rg,
        pm.tri_feat, pm.cl_first, pm.width, T_MIN, interpret=True,
        stride=pm.stride, smem_nodes=pm.smem_nodes, top_rows=pm.top_rows,
        nodes_top=pm.nodes_top, quant=pm.quant, qparams=pm.qparams,
        dense_thresh=dense_thresh)
    tabs = cb.heap_tables(tm)
    t_, tri, cnt = crg.rg_trace(tv(o), tv(d), FLT_MAX, tabs, T_MIN)
    outs = cb.winner_features(tv(o), tv(d), t_, tri, tabs.tri_feat)
    jtri, tri = np.asarray(jouts[1]), tri.numpy()
    hit = jtri >= 0
    assert hit.sum() > 100
    np.testing.assert_array_equal(tri >= 0, hit)
    assert_ids_or_ties(jm, o, d, tri, jtri, hit)
    assert_hits_match_jax(jm, o, d, jouts, outs)
    tot = cnt.sum(1, dtype=torch.int64)
    assert tot[0] > 0 and tot[2] > 0 and tot[3] == 0


@pytest.mark.parametrize("t,seed,ppl", [
    (4000, 7, 64),
    (4000, 11, 16),   # small leaves: many staged a round on the card
    (1777, 13, 32),
    (512, 9, 64),     # few leaves, most rays share them
    (6000, 15, 64),
])
def test_rg_walk_against_heap_walk(t, seed, ppl):
    """t bit-equal to the heap walk, winners except exact ties, and leaf
    visits never fewer and at most 1.5x + 4; dead lanes (t_max = -1) test
    nothing."""
    jm, tm = both_meshes(t, seed=seed, ppl=ppl)
    tabs = cb.heap_tables(tm)
    o, d = rays(2048, seed=seed + 1)
    tmv = np.where(np.arange(2048) % 5 == 0, -1.0,
                   FLT_MAX).astype(np.float32)
    for tmax in (FLT_MAX, torch.from_numpy(tmv)):
        t, tri, cnt = crg.rg_trace(tv(o), tv(d), tmax, tabs, T_MIN)
        te, tre, ce = cb.heap_trace(tv(o), tv(d), tmax, tabs, T_MIN)
        assert torch.equal(t, te)
        hit = tre.numpy() >= 0
        assert hit.sum() > 100
        np.testing.assert_array_equal(tri.numpy() >= 0, hit)
        assert_ids_or_ties(jm, o, d, tri.numpy(), tre.numpy(), hit)
        visits, visits_heap = int(cnt[2].sum()), int(ce[2].sum())
        assert visits_heap <= visits <= visits_heap * 1.5 + 4
    assert not cnt[:, torch.from_numpy(tmv < 0)].any()
    assert (tri[torch.from_numpy(tmv < 0)] == -1).all()


def _ties_only(mesh, o, d, got, want, hit):
    """Winner heap slots equal, except on lanes where both slots give the
    same t to float32 precision (no count bound: the tie cases)."""
    diff = hit & (got != want)
    if diff.any():
        np.testing.assert_allclose(tri_t(mesh, o[diff], d[diff], got[diff]),
                                   tri_t(mesh, o[diff], d[diff],
                                         want[diff]), rtol=2e-6)


def _case_walk(name):
    """A contract case on the CPU: the case, its port mesh, and the plain
    regrouped walk's (t, tri, counters) after the case's own check."""
    c = rg_cases.case(name)
    mesh = rg_cases.port_mesh(c, "cpu")
    tabs = cb.heap_tables(mesh)
    t, tri, cnt = crg.rg_trace(tv(c.o), tv(c.d), torch.from_numpy(c.t_max),
                               tabs, rg_cases.T_MIN)
    c.check(t.numpy(), tri.numpy(), cnt.numpy())
    return c, mesh, tabs, t.numpy(), tri.numpy(), cnt


@pytest.mark.parametrize("name", rg_cases.CASES)
def test_rg_contract_cases_against_heap_walk(name):
    """Each case's own check, then against the heap walk: t bit for bit
    (NaN where t_max is NaN), hits equal, winners except exact ties, leaf
    visits in [heap, 1.5 x heap + 4]."""
    c, mesh, tabs, t, tri, cnt = _case_walk(name)
    te, tre, ce = cb.heap_trace(tv(c.o), tv(c.d), torch.from_numpy(c.t_max),
                                tabs, rg_cases.T_MIN)
    np.testing.assert_array_equal(t, te.numpy())
    hit = tre.numpy() >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    _ties_only(mesh, c.o, c.d, tri, tre.numpy(), hit)
    visits, visits_heap = int(cnt[2].sum()), int(ce[2].sum())
    assert visits_heap <= visits <= visits_heap * 1.5 + 4
    assert not cnt[:, ~(c.t_max > 0)].any()


@pytest.mark.parametrize("name", [n for n in rg_cases.CASES
                                  if n not in JAX_REFUSES])
def test_rg_contract_cases_match_jax_kernel(name):
    """Against ``packet_trace_rg`` in interpret mode, to
    test_rg_walk_matches_jax_kernel's standard: hits equal, winners
    where t is unique, t within the XLA-contraction bound on hits and
    equal to t_max on misses."""
    c, mesh, _, t, tri, _ = _case_walk(name)
    jm = _jax_mesh(c)
    rg = build_packet_rg(jm, max_width=JAX_WIDTH.get(name, 64))
    pm = rg.pm
    tmax = np.where(np.isnan(c.t_max), np.float32(-1.0), c.t_max)
    jouts, _ = packet_trace_rg(
        jv(c.o), jv(c.d), jnp.asarray(tmax), pm.nodes, pm.blocks,
        rg.blocks_rg, pm.tri_feat, pm.cl_first, pm.width, rg_cases.T_MIN,
        interpret=True, stride=pm.stride, smem_nodes=pm.smem_nodes,
        top_rows=pm.top_rows, nodes_top=pm.nodes_top, quant=pm.quant,
        qparams=pm.qparams)
    jt, jtri = np.asarray(jouts[0]), np.asarray(jouts[1])
    hit = jtri >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    _ties_only(mesh, c.o, c.d, tri, jtri, hit)
    v0 = mesh.v0.numpy()
    with np.errstate(invalid="ignore"):  # sentinel slots: inf - inf
        e1, e2 = mesh.v1.numpy() - v0, mesh.v2.numpy() - v0
    tol_t = _tol(c.o, c.d, (v0, e1, e2, np.cross(e1, e2)), tri, t)[0]
    assert (np.abs(t - jt)[hit] <= tol_t[hit]).all()
    np.testing.assert_array_equal(t[~hit], np.where(np.isnan(c.t_max),
                                                    np.nan, jt)[~hit])
