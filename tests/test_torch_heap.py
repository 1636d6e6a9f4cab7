"""The heap BVH walk's contract cases (``tests/heap_cases.py``, held
kernel against plain walk on the card): the port's plain walk
(``ops/cuda_bvh.py``) against the JAX package's ``packet_trace`` /
``packet_occluded`` (``tpu_pathtracer/ops/pallas_bvh.py``, interpret
mode), on the CPU.

Tolerances, those of ``test_torch_packet.py``'s
``test_heap_walk_matches_jax_kernels``: hit masks and occlusion equal;
winners equal where t is unique (``assert_ids_or_ties``); t within 2e-6
relative on every hit (XLA contracts multiply-adds into FMAs on the CPU,
PyTorch does not), and equal to t_max on a miss. The plain walk keeps
the exact division in its fast_math mode, so it is held in both modes;
the JAX kernels run exact.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_bvh4 import assert_ids_or_ties, jv, tv
from tpu_pathtracer.models.scene import MeshData as JMeshData
from tpu_pathtracer.ops import bvh as jbvh
from tpu_pathtracer.ops.pallas_bvh import (build_packet_mesh,
                                           packet_occluded, packet_trace)
from tpu_pathtracer_torch.ops import cuda_bvh as cb
import heap_cases
from torch_threads import one_torch_thread  # noqa: F401

T_MIN = heap_cases.T_MIN


def _jax_mesh(c):
    """A contract case's heap mesh in the JAX package (its layout, or its
    soup through ``build_bvh``)."""
    if c.soup is not None:
        return jbvh.build_bvh(*heap_cases.soup(**c.soup),
                              prims_per_leaf=c.P, bvh4=False)
    v0, v1, v2 = c.slots
    nl = v0.shape[0] // c.P
    bmin, bmax = jbvh._node_boxes(v0, v1, v2, nl, c.P)
    n = v0.shape[0]
    return JMeshData(v0=jnp.asarray(v0), v1=jnp.asarray(v1),
                     v2=jnp.asarray(v2),
                     tex_coords=jnp.zeros((n, 6), jnp.float32),
                     mesh_id=jnp.zeros((n,), jnp.int32),
                     bvh_min=jnp.asarray(bmin), bvh_max=jnp.asarray(bmax),
                     bounds_min=jnp.asarray(bmin[1]),
                     bounds_max=jnp.asarray(bmax[1]), first_leaf=nl,
                     prims_per_leaf=c.P)


@pytest.mark.parametrize("mode", ["nearest", "any_hit"])
@pytest.mark.parametrize("name", heap_cases.CASES)
def test_contract_cases_match_jax_kernels(name, mode):
    """The plain walk meets each case's own check in both arithmetic
    modes, and agrees with the JAX kernel of ``mode`` in interpret mode:
    nearest hits (mask, winners but ties, t) or occlusion."""
    c = heap_cases.case(name)
    tabs = cb.heap_tables(heap_cases.port_mesh(c, "cpu"))
    o, d, tmax = tv(c.o), tv(c.d), torch.from_numpy(c.t_max)
    for approx in (False, True):
        t, tri, cnt = cb.heap_trace(o, d, tmax, tabs, T_MIN,
                                    approx_recip=approx)
        occ, ocnt = cb.heap_occluded(o, d, tmax, tabs, T_MIN,
                                     approx_recip=approx)
        c.check(t.numpy(), tri.numpy(), occ.numpy(), cnt.numpy())
    # any-hit walks the nearest walk's steps up to its first hit
    assert bool((ocnt <= cnt).all())

    jm = _jax_mesh(c)
    pm = build_packet_mesh(jm, max_width=64)
    args = (jv(c.o), jv(c.d), jnp.asarray(c.t_max), pm.nodes, pm.blocks)
    kw = dict(interpret=True, stride=pm.stride, cpb=pm.cpb,
              smem_nodes=pm.smem_nodes)
    if mode == "any_hit":
        jocc, _ = packet_occluded(*args, pm.cl_first, pm.width, T_MIN, **kw)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
        return
    jouts, _ = packet_trace(*args, pm.tri_feat, pm.cl_first, pm.width,
                            T_MIN, **kw)
    jt, jtri = np.asarray(jouts[0]), np.asarray(jouts[1])
    t, tri = t.numpy(), tri.numpy()
    hit = jtri >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    assert_ids_or_ties(jm, c.o, c.d, tri, jtri, hit)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=2e-6)
    np.testing.assert_array_equal(t[~hit], jt[~hit])


def test_nan_u_case_takes_a_slot_with_nan_u():
    """The nan_u case's winner is a slot whose u and v are NaN while its
    a and t are finite, in the plain walk's arithmetic."""
    c = heap_cases.case("nan_u")
    tabs = cb.heap_tables(heap_cases.port_mesh(c, "cpu"))
    o, d = torch.from_numpy(c.o), torch.from_numpy(c.d)
    rows = tabs.tri[40].expand(c.o.shape[0], 1, 12)
    v0x, v0y, v0z, g1x, g1y, g1z, g2x, g2y, g2z, n1, n2, n3 = \
        rows[:, 0].unbind(1)
    a = -(d[:, 0] * n1 + d[:, 1] * n2 + d[:, 2] * n3)
    assert bool((a.abs() >= 1e-7).all()) and torch.isfinite(a).all()
    t, hit = cb.mt_rows(rows, o, d, T_MIN, torch.full((64,), 9.0))
    assert bool(hit.all()) and bool((t == 1.0).all())
    s = o - torch.stack([v0x, v0y, v0z], 1)
    q = torch.linalg.cross(s, d)
    assert bool(torch.isinf(q[:, 0]).all())
    u = (q[:, 0] * g2x + q[:, 1] * g2y + q[:, 2] * g2z) / a
    assert bool(torch.isnan(u).all())


def test_near_bound_case_lies_within_the_margin():
    """Each near_bound lane's winning or losing slot-3 test has its exact
    (float64) u, v, u + v or t within 2^-20 of an accept bound, up to the
    float32 rounding (2^-24 relative) of the lane's inputs."""
    c = heap_cases.case("near_bound")
    v0, v1, v2 = (x[3].astype(np.float64) for x in c.slots)
    o, d = c.o.astype(np.float64), c.d.astype(np.float64)
    e1, e2 = v1 - v0, v2 - v0
    n = np.cross(e1, e2)
    a = -(d @ n)
    s = o - v0
    q = np.cross(s, d)
    u, v, t = q @ e2 / a, -(q @ e1) / a, s @ n / a
    lo = float(np.float32(T_MIN))
    tm = c.t_max.astype(np.float64)
    near_tmax = np.where(tm < 1e30, (t - tm) / tm, np.inf)
    gap = np.min(np.abs(np.stack([u, v, u + v - 1, (t - lo) / lo,
                                  near_tmax])), axis=0)
    assert (gap <= heap_cases.DELTA + 2.0 ** -24).all() and (gap > 0).all()
