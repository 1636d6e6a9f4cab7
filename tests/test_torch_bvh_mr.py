"""The packet walk with leaf queues (``ops/cuda_bvh_mr.py``, K12a/K12b):
its plain version against the JAX package's multirow kernel
(``experiments/pallas_bvh_mr.py``: ``packet_trace_mr`` /
``packet_occluded_mr``, interpret mode) on ``experiments/mr_exactness.py``'s
meshes and rays, and against the port's plain heap walk (K5/K6), which it
must equal per ray.

Tolerances. Against JAX: hit masks and occlusion exact, winners except on
exact ties (the two walks test leaves in other orders; ROADMAP C-3), t, u,
v and the features within ``test_torch_bvh_mx.assert_hits_match_jax``'s
XLA-contraction bounds (the bounds ``test_torch_packet.py`` holds K5 to:
XLA contracts multiply-adds into FMAs on the CPU, PyTorch does not).
Against the heap walk: t bit-equal, winners equal where t is unique,
occlusion equal. The counters count per 32-ray packet and are compared
with neither (ROADMAP C-4). The CUDA kernel runs only on a card:
``tests/test_torch_cuda.py`` holds it bit for bit, counters included,
against this plain version.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from test_torch_bvh4 import T_MIN, assert_ids_or_ties, both_meshes, jv, \
    rays, tv
from test_torch_bvh_mx import assert_hits_match_jax
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh_mr as cmr
from tpu_pathtracer_torch.ops.vec import FLT_MAX
from torch_threads import one_torch_thread  # noqa: F401

_MR_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "experiments", "pallas_bvh_mr.py")

# mr_exactness.py's cases: (triangles, mesh seed, per leaf, rays, ray seed)
CASES = {"t2000_ppl16": (2000, 0, 16, 600, 1),
         "t3000_ppl8": (3000, 7, 8, 700, 8)}


@pytest.fixture(scope="module")
def jmr():
    """experiments/pallas_bvh_mr.py, imported by its path."""
    spec = importlib.util.spec_from_file_location("pallas_bvh_mr", _MR_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(name):
    t, seed, ppl, n, rseed = CASES[name]
    jm, tm = both_meshes(t, seed, ppl=ppl)
    o, d = rays(n, rseed)
    return jm, tm, o, d


@pytest.mark.parametrize("name", sorted(CASES))
def test_mr_walk_matches_jax_kernel(jmr, name):
    jm, tm, o, d = _case(name)
    pm = jmr.build_packet_mr(jm, max_width=32)
    jouts, jcnt = jmr.packet_trace_mr(
        jv(o), jv(d), FLT_MAX, pm.ntab, pm.blocks, pm.tri_feat, pm.cl_first,
        pm.width, pm.n_blocks, T_MIN, interpret=True)
    tabs = cb.heap_tables(tm)
    outs, cnt = cmr.mr_trace(tv(o), tv(d), FLT_MAX, tabs, T_MIN)
    jtri, tri = np.asarray(jouts[1]), outs[1].numpy()
    hit = jtri >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    assert hit.sum() > 100
    assert_ids_or_ties(jm, o, d, tri, jtri, hit)
    assert_hits_match_jax(jm, o, d, jouts, outs)
    assert cnt.shape == (3, (o.shape[0] + 31) // 32)
    assert int(cnt[2].sum()) > 0 and int(jcnt[2]) > 0

    jocc, _ = jmr.packet_occluded_mr(
        jv(o), jv(d), 14.0, pm.ntab, pm.blocks, pm.cl_first, pm.width,
        pm.n_blocks, T_MIN, interpret=True)
    occ, _ = cmr.mr_occluded(tv(o), tv(d), 14.0, tabs, T_MIN)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert 0 < occ.sum() < hit.sum()


@pytest.mark.parametrize("name", sorted(CASES) + ["t8000_ppl64"])
def test_mr_walk_equals_heap_walk(name):
    """Per ray the heap walk's results, on a per-lane t_max with dead
    lanes (t_max -1) and inert ones (t_max 0); the third mesh has the
    dragon's 64 triangles a leaf."""
    if name in CASES:
        jm, tm, o, d = _case(name)
    else:
        jm, tm = both_meshes(8000, 3, ppl=64)
        o, d = rays(500, 4)
    tabs = cb.heap_tables(tm)
    n = o.shape[0]
    lane = np.arange(n)
    tmv = np.where(lane % 7 == 0, -1.0,
                   np.where(lane % 11 == 0, 0.0, 9.0 + lane % 5)
                   ).astype(np.float32)
    for t_max in (FLT_MAX, torch.from_numpy(tmv)):
        t, tri, _, cnt = cmr._mr_walk_ref(
            tv(o), tv(d), cb._tmax_vector(t_max, n, tv(o).x), tabs, T_MIN,
            False)
        t5, tri5, _ = cb._heap_trace_ref(tv(o), tv(d), t_max, tabs, T_MIN)
        assert torch.equal(t, t5)
        hit = tri5.numpy() >= 0
        np.testing.assert_array_equal(tri.numpy() >= 0, hit)
        assert_ids_or_ties(jm, o, d, tri.numpy(), tri5.numpy(), hit)
        occ, _ = cmr.mr_occluded(tv(o), tv(d), t_max, tabs, T_MIN)
        occ6, _ = cb._heap_occluded_ref(tv(o), tv(d), t_max, tabs, T_MIN)
        assert torch.equal(occ, occ6)
        assert occ.any() and not occ.all()
    assert not occ[torch.from_numpy(tmv <= 0)].any()
    assert (tri[torch.from_numpy(tmv <= 0)] == -1).all()


def test_missing_packet_and_dead_lanes():
    """A packet whose rays all miss: every t is its t_max, no winner, no
    leaf queued below the root. Any-hit: a packet of lanes at t_max < 0
    retires at once (one root step entering nothing), lanes at t_max 0
    stay inert, and a lone live lane still finds its hit."""
    jm, tm = both_meshes(2000, 0)
    tabs = cb.heap_tables(tm)
    n = 64
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = 50.0  # outside the soup's box, heading away from it
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    (t, tri, *_), cnt = cmr.mr_trace(tv(o), tv(d), 30.0, tabs, T_MIN)
    assert (tri == -1).all() and (t == 30.0).all()
    assert cnt.shape == (3, 2) and int(cnt.sum()) == 0

    o2, d2 = rays(n, 1)
    hits, _ = cb._heap_occluded_ref(tv(o2), tv(d2), FLT_MAX, tabs, T_MIN)
    live = 32 + int(hits[32:].nonzero()[0])
    tmv = np.full(n, -1.0, np.float32)
    tmv[32:] = 0.0
    tmv[live] = FLT_MAX
    occ, cnt = cmr.mr_occluded(tv(o2), tv(d2), torch.from_numpy(tmv), tabs,
                               T_MIN)
    assert int(cnt[:, 0].sum()) == 0  # the retired packet
    occ6, _ = cb._heap_occluded_ref(tv(o2), tv(d2), torch.from_numpy(tmv),
                                    tabs, T_MIN)
    assert torch.equal(occ, occ6) and bool(occ6[live]) and \
        int(occ.sum()) == 1


def test_cpu_tensors_take_the_plain_version():
    _, tm = both_meshes(2000, 0)
    tabs = cb.heap_tables(tm)
    o, d = rays(64, 2)
    before = dict(cmr.LAUNCHES)
    cmr.mr_trace(tv(o), tv(d), FLT_MAX, tabs, T_MIN)
    cmr.mr_occluded(tv(o), tv(d), 10.0, tabs, T_MIN)
    assert cmr.LAUNCHES == before
