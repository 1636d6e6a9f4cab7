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
"""

import numpy as np
import pytest
import torch

from test_torch_bvh4 import T_MIN, assert_ids_or_ties, both_meshes, jv, \
    rays, tv
from test_torch_bvh_mx import assert_hits_match_jax
from tpu_pathtracer.ops.pallas_bvh_rg import build_packet_rg, packet_trace_rg
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh_rg as crg
from tpu_pathtracer_torch.ops.vec import FLT_MAX


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
