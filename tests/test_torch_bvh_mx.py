"""The MXU-leaf heap walk of the port (ops/cuda_bvh_mx.py, plain version)
against the JAX package's ``packet_trace_mx`` / ``packet_occluded_mx``
(``tpu_pathtracer/ops/pallas_bvh_mx.py``, interpret mode) and against the
port's exact heap walk.

Tolerances. The test columns G equal the JAX package's G block entries
within 1e-6 of each column's largest magnitude (XLA contracts the cross
products into FMAs on the CPU, PyTorch does not). Hit masks and occlusion
are exact. Winner ids agree except near-ties: a lane whose winners differ
must have both winners' exact (float64) t within 1e-4 relative, and at
most 1% of the hits may (measured: 0 of 1,689 hits, at 3 and 6 passes,
and 0 against the exact walk). t on every hit, and u and v where the
winners agree, from ``exact_winner`` match the JAX package's
``_exact_winner`` within the XLA-contraction bound of
``tests/test_torch_tris.py`` (``_tol``: a few ulps of each 3-term dot's
magnitude over |a|); tu and tv within the sum of the u and v bounds plus
1e-5; normals rtol 2e-6, atol 1e-6 (``tests/test_torch_packet.py``). The
port's t equals its exact heap walk's bit for bit.

On a patch of the dragon-class knot (its tessellation, coordinates and
camera; 2048 rays at random points of the patch) the split-bf16 test
departs from the exact walk where a hit lies near an edge or at grazing
incidence. Measured on this patch: 20 of 2048 hits at 3 passes and 2 at
6 (the JAX kernel 22 and 1; the port and it differ on 2 and 1 lanes);
three other patches read 0.4-1.1% at 3 passes. So there: winners differ
between the port and the JAX kernel on at most 0.5% of the lanes, and
from the exact walk on at most 2% of the hits at 3 passes and 0.5% at 6;
and every such lane is one the split-bf16 test can misjudge: on one of
its winners (the exact walk's, the port's or the JAX kernel's) the hit
point's exact barycentric distance to an edge times the cosine of the
incidence is at most 2e-3 (measured: 9.7e-4 at most; 9.7% of all hits
are that close).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_bvh4 import T_MIN, jv, soup, tri_t, tv
from test_torch_tris import _tol
from tpu_pathtracer.models.scene import MeshData as JMeshData
from tpu_pathtracer.ops import bvh as jbvh
from tpu_pathtracer.ops.pallas_bvh_mx import (build_packet_mx,
                                              packet_occluded_mx,
                                              packet_trace_mx)
from tpu_pathtracer_torch.models.shapes import torus_knot_mesh
from tpu_pathtracer_torch.ops import bvh as tbvh
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh_mx as cmx
from tpu_pathtracer_torch.ops.vec import FLT_MAX
import bvh_mx_cases

OFFSET = 30.0  # moves the soup off the origin, so G is recentred
# (JAX block row, G column group, port column) of every used G entry
G_ENTRIES = ([(r, 0, c) for r, c in zip((0, 1, 2), range(0, 3))]
             + [(r, 1, c) for r, c in zip((3, 4, 5, 9), range(3, 7))]
             + [(r, 2, c) for r, c in zip((0, 1, 2, 6, 7, 8), range(7, 13))]
             + [(r, 3, c) for r, c in zip((0, 1, 2, 6, 7, 8), range(13, 19))])


def _meshes(t=4000, seed=0):
    base, v1, v2, tc, mid = soup(t, seed)
    arrays = (base + OFFSET, v1 + OFFSET, v2 + OFFSET, tc, mid)
    return (jbvh.build_bvh(*arrays, prims_per_leaf=64, bvh4=False),
            tbvh.build_bvh(*arrays, prims_per_leaf=64, bvh4=False,
                           device="cpu"))


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32) + OFFSET
    d = rng.uniform(-8, 8, (n, 3)).astype(np.float32) + OFFSET - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def assert_hits_match_jax(mesh, o, d, jouts, outs):
    """The port's winner tuple ``outs`` (t, tri, u, v, nx, ny, nz, tu, tv,
    mid) against the JAX package's ``jouts`` on the same rays: t of every
    hit, and the rest where the winners agree, within the XLA-contraction
    bounds (module docstring); misses keep FLT_MAX."""
    ja = [np.asarray(x) for x in jouts]
    pa = [x.numpy() for x in outs]
    tri, hit = pa[1], pa[1] >= 0
    same = hit & (tri == ja[1])
    v0 = np.asarray(mesh.v0)
    with np.errstate(invalid="ignore"):  # sentinel slots: inf - inf
        e1, e2 = np.asarray(mesh.v1) - v0, np.asarray(mesh.v2) - v0
    tol_t, tol_u, tol_v = _tol(o, d, (v0, e1, e2, np.cross(e1, e2)), tri,
                               pa[0])
    assert (np.abs(pa[0] - ja[0])[hit] <= tol_t[hit]).all()
    np.testing.assert_array_equal(pa[0][~hit], np.float32(FLT_MAX))
    for k, tol in ((2, tol_u), (3, tol_v), (7, tol_u + tol_v + 1e-5),
                   (8, tol_u + tol_v + 1e-5)):
        assert (np.abs(pa[k] - ja[k])[same] <= tol[same]).all(), k
    for k in (4, 5, 6):
        np.testing.assert_allclose(pa[k][same], ja[k][same], rtol=2e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(pa[9][same], ja[9][same])


def _assert_near_ties(mesh, o, d, got, want, hit):
    """Winners equal, except on lanes where both winners' exact t agree to
    1e-4 relative, at most 1% of the hits."""
    diff = hit & (got != want)
    if diff.any():
        ta = tri_t(mesh, o[diff], d[diff], got[diff])
        tb = tri_t(mesh, o[diff], d[diff], want[diff])
        np.testing.assert_allclose(ta, tb, rtol=1e-4)
    assert diff.sum() <= max(2, hit.sum() // 100)


@pytest.fixture(scope="module")
def meshes():
    jm, tm = _meshes()
    return jm, tm, build_packet_mx(jm, max_width=64), cmx.mx_tables(tm)


def test_tables_match_jax_blocks(meshes):
    """G holds the JAX package's G block entries that are not zero by
    construction, per slot, and the same pow2 recentering."""
    _, _, mx, tabs = meshes
    np.testing.assert_array_equal(tabs.center.numpy(), np.asarray(mx.center))
    assert tabs.center.numpy().tolist() == [32.0, 32.0, 32.0]
    g = np.asarray(mx.gblocks)  # [C, 16, 4w]
    c, _, w4 = g.shape
    w = w4 // 4
    assert w == tabs.heap.prims_per_leaf and c == tabs.heap.first_leaf
    port = tabs.g.numpy().reshape(c, w, cmx.G_COLUMNS)
    for row, grp, col in G_ENTRIES:
        want = g[:, row, grp * w:(grp + 1) * w]
        scale = np.abs(want).max()
        np.testing.assert_allclose(port[:, :, col], want, rtol=0,
                                   atol=1e-6 * scale)
    # the rows the port drops are zero in the JAX block
    used = {(r, grp) for r, grp, _ in G_ENTRIES}
    for grp in range(4):
        for row in range(16):
            if (row, grp) not in used:
                assert not g[:, row, grp * w:(grp + 1) * w].any()
    assert not port[:, :, 19].any()


@pytest.mark.parametrize("passes", [3, 6])
def test_mx_walk_matches_jax_kernels(meshes, passes):
    jm, _, mx, tabs = meshes
    pm = mx.pm
    o, d = _rays(2048, seed=1)
    kw = dict(center=mx.center, passes=passes, interpret=True,
              smem_nodes=pm.smem_nodes, top_rows=pm.top_rows,
              nodes_top=pm.nodes_top)
    jouts, _ = packet_trace_mx(jv(o), jv(d), FLT_MAX, pm.nodes, mx.gblocks,
                               mx.tri_geom, pm.cl_first, pm.width, T_MIN,
                               **kw)
    tk, tri, cnt = cmx.mx_trace(tv(o), tv(d), FLT_MAX, tabs, T_MIN, passes)
    outs = cmx.exact_winner(tv(o), tv(d), tk, tri, tabs.heap.tri_feat)
    jtri, tri = np.asarray(jouts[1]), tri.numpy()
    hit = jtri >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    assert hit.sum() > 1000
    _assert_near_ties(jm, o, d, tri, jtri, hit)
    assert_hits_match_jax(jm, o, d, jouts, outs)
    tot = cnt.sum(1, dtype=torch.int64)
    assert tot[0] > 0 and tot[2] > 0 and tot[3] == 0

    tmv = np.where(np.arange(2048) % 3 == 0, -1.0, 9.0).astype(np.float32)
    for tmax in (12.0, tmv):
        jocc, _ = packet_occluded_mx(jv(o), jv(d), jnp.asarray(tmax),
                                     pm.nodes, mx.gblocks, pm.cl_first,
                                     pm.width, T_MIN, **kw)
        occ, ocnt = cmx.mx_occluded(tv(o), tv(d), torch.as_tensor(tmax),
                                    tabs, T_MIN, passes)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
        if isinstance(tmax, np.ndarray):
            assert bool((ocnt[:, torch.from_numpy(tmax <= 0)] == 0).all())
            assert not occ.numpy()[tmax <= 0].any()


def test_mx_walk_against_exact_heap_walk(meshes):
    """The split-bf16 leaf test picks the exact walk's winners (near-ties
    aside), and exact_winner gives the exact walk's t, u and v."""
    jm, tm, _, tabs = meshes
    o, d = _rays(2048, seed=2)
    tk, tri, _ = cmx.mx_trace(tv(o), tv(d), FLT_MAX, tabs, T_MIN)
    outs = cmx.exact_winner(tv(o), tv(d), tk, tri, tabs.heap.tri_feat)
    te, tre, _ = cb.heap_trace(tv(o), tv(d), FLT_MAX, tabs.heap, T_MIN)
    ref = cb.winner_features(tv(o), tv(d), te, tre, tabs.heap.tri_feat)
    tri, tre = tri.numpy(), tre.numpy()
    hit = tre >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    _assert_near_ties(jm, o, d, tri, tre, hit)
    same = (tri == tre)
    for k in (0, 2, 3, 7, 8, 9):  # t, u, v, tu, tv, mid
        np.testing.assert_array_equal(outs[k].numpy()[same],
                                      ref[k].numpy()[same])


def test_g_parts_are_the_split_of_g(meshes):
    """The kernel's table of G's bf16 parts holds ``_split3``'s hi, mid
    and lo of every test column bit for bit, ``_split_g``'s parts at
    either pass count, and zeros in its padding; the centre's values are
    the centre tensor's."""
    *_, tabs = meshes
    parts = tabs.parts
    assert parts.dtype == torch.bfloat16
    assert parts.shape == (tabs.g.shape[0], cmx.PART_COLUMNS)
    wide = parts.to(torch.float32)
    cols = cmx.G_COLUMNS
    got = [wide[:, k * cols:(k + 1) * cols] for k in range(3)]
    for a, b in zip(got, cmx._split3(tabs.g)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for passes in cmx.PASSES:
        for a, b in zip(got, cmx._split_g(tabs.g, passes)):
            if b is not None:
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not wide[:, 3 * cols:].any()
    assert tabs.center_xyz == tuple(tabs.center.tolist())


def _case_meshes(c):
    """A contract case's mesh in both packages, and the port's tables."""
    tm = bvh_mx_cases.port_mesh(c, "cpu")
    if c.soup is not None:
        jm = jbvh.build_bvh(*bvh_mx_cases.soup(**c.soup),
                            prims_per_leaf=c.P, bvh4=False)
    else:
        v0, v1, v2 = c.slots
        nl = v0.shape[0] // c.P
        bmin, bmax = jbvh._node_boxes(v0, v1, v2, nl, c.P)
        n = v0.shape[0]
        jm = JMeshData(v0=jnp.asarray(v0), v1=jnp.asarray(v1),
                       v2=jnp.asarray(v2),
                       tex_coords=jnp.zeros((n, 6), jnp.float32),
                       mesh_id=jnp.zeros((n,), jnp.int32),
                       bvh_min=jnp.asarray(bmin), bvh_max=jnp.asarray(bmax),
                       bounds_min=jnp.asarray(bmin[1]),
                       bounds_max=jnp.asarray(bmax[1]), first_leaf=nl,
                       prims_per_leaf=c.P)
    return jm, cmx.mx_tables(tm)


@pytest.mark.parametrize("passes", [3, 6])
@pytest.mark.parametrize("name", bvh_mx_cases.CASES)
def test_contract_cases_match_jax_kernels(name, passes):
    """The leaf test's edge cases (tests/bvh_mx_cases.py, held kernel
    against plain on the card): the plain walk meets each case's own
    check, and agrees with the JAX kernels in interpret mode as
    test_mx_walk_matches_jax_kernels holds it: hits and occlusion equal,
    winners but near-ties, t within the XLA-contraction bound."""
    c = bvh_mx_cases.case(name)
    jm, tabs = _case_meshes(c)
    mx = build_packet_mx(jm, max_width=64)
    pm = mx.pm
    o, d, tmax = tv(c.o), tv(c.d), torch.from_numpy(c.t_max)
    tk, tri, cnt = cmx.mx_trace(o, d, tmax, tabs, bvh_mx_cases.T_MIN,
                                passes)
    occ, ocnt = cmx.mx_occluded(o, d, tmax, tabs, bvh_mx_cases.T_MIN,
                                passes)
    c.check(tk.numpy(), tri.numpy(), occ.numpy(), cnt.numpy())
    # any-hit walks the nearest walk's steps up to its first hit
    assert bool((ocnt <= cnt).all())

    kw = dict(center=mx.center, passes=passes, interpret=True,
              smem_nodes=pm.smem_nodes, top_rows=pm.top_rows,
              nodes_top=pm.nodes_top)
    jouts, _ = packet_trace_mx(jv(c.o), jv(c.d), jnp.asarray(c.t_max),
                               pm.nodes, mx.gblocks, mx.tri_geom,
                               pm.cl_first, pm.width, bvh_mx_cases.T_MIN,
                               **kw)
    jtri, tri = np.asarray(jouts[1]), tri.numpy()
    hit = jtri >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    _assert_near_ties(jm, c.o, c.d, tri, jtri, hit)
    t = cmx.exact_winner(o, d, tk, torch.from_numpy(tri),
                         tabs.heap.tri_feat)[0].numpy()
    v0 = np.asarray(jm.v0)
    with np.errstate(invalid="ignore", over="ignore"):
        e1, e2 = np.asarray(jm.v1) - v0, np.asarray(jm.v2) - v0
        tol_t = _tol(c.o, c.d, (v0, e1, e2, np.cross(e1, e2)), tri, t)[0]
    assert (np.abs(t - np.asarray(jouts[0]))[hit] <= tol_t[hit]).all()
    jocc, _ = packet_occluded_mx(jv(c.o), jv(c.d), jnp.asarray(c.t_max),
                                 pm.nodes, mx.gblocks, pm.cl_first,
                                 pm.width, bvh_mx_cases.T_MIN, **kw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_nan_u_case_takes_a_slot_with_nan_u():
    """The nan_u case's winner is a slot whose split-bf16 u is NaN while
    its a and t are finite, at both pass counts."""
    c = bvh_mx_cases.case("nan_u")
    tabs = cmx.mx_tables(bvh_mx_cases.port_mesh(c, "cpu"))
    o, d = tv(c.o), tv(c.d)
    fparts = cmx.ray_features(o, d, tabs.center)
    rows = tabs.g[12].expand(c.o.shape[0], 1, cmx.G_COLUMNS)
    for passes in cmx.PASSES:
        a, tn, un, _ = cmx.numerators(rows, fparts, passes)
        assert torch.isfinite(a).all() and torch.isfinite(tn / a).all()
        assert torch.isnan(un / a).all()


def test_passes_other_than_3_or_6_raise(meshes):
    *_, tabs = meshes
    o, d = _rays(8, seed=3)
    with pytest.raises(ValueError, match="mx_passes"):
        cmx.mx_trace(tv(o), tv(d), FLT_MAX, tabs, T_MIN, passes=4)


DRAGON_TESS = (1664, 262)  # knot_zoo_scene's dragon-class nu, nv
DRAGON_EYE = (11.0, 8.0, 11.0)  # its camera
MISJUDGED = 2e-3  # edge distance x incidence cosine (module docstring)


def _dragon_patch(rows=12, first=400):
    """Both triangles of the quads of ``rows`` consecutive rings of the
    dragon-class knot's tube: its triangles, as the full mesh has them."""
    nu, nv = DRAGON_TESS
    v0, v1, v2, tc = torus_knot_mesh(nu, nv)
    q = np.arange(first * nv, (first + rows) * nv)
    ids = np.concatenate([q, q + v0.shape[0] // 2])
    return (v0[ids], v1[ids], v2[ids], tc[ids],
            np.ones(ids.size, np.int32))


def _edge_times_cos(mesh, o, d, ids):
    """Per lane, float64: the hit point's barycentric distance to the
    nearest edge of triangle ``ids``, times the cosine of the incidence."""
    v0 = np.asarray(mesh.v0, np.float64)[ids]
    e1 = np.asarray(mesh.v1, np.float64)[ids] - v0
    e2 = np.asarray(mesh.v2, np.float64)[ids] - v0
    n = np.cross(e1, e2)
    a = -(d * n).sum(1)
    q = np.cross(o - v0, d)
    u = (q * e2).sum(1) / a
    v = -(q * e1).sum(1) / a
    edge = np.abs(np.minimum(np.minimum(u, v), 1 - u - v))
    return edge * np.abs(a) / np.linalg.norm(n, axis=1)


@pytest.fixture(scope="module")
def dragon_patch():
    arrays = _dragon_patch()
    jm = jbvh.build_bvh(*arrays, prims_per_leaf=64, bvh4=False)
    tm = tbvh.build_bvh(*arrays, prims_per_leaf=64, bvh4=False, device="cpu")
    rng = np.random.RandomState(11)
    n = 2048
    k = rng.randint(0, arrays[0].shape[0], n)
    b = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    p = b[:, :1] * arrays[0][k] + b[:, 1:2] * arrays[1][k] + \
        b[:, 2:] * arrays[2][k]
    o = np.broadcast_to(np.float32(DRAGON_EYE), (n, 3)).copy()
    d = p - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jm, build_packet_mx(jm, max_width=64), cmx.mx_tables(tm), o, d


@pytest.mark.parametrize("passes", [3, 6])
def test_mx_walk_matches_jax_on_dragon_patch(dragon_patch, passes):
    """The port's departures from the exact walk at the dragon's scale
    are the JAX kernel's, and each lies where the split-bf16 test can
    misjudge a hit (module docstring)."""
    jm, mx, tabs, o, d = dragon_patch
    pm = mx.pm
    jouts, _ = packet_trace_mx(
        jv(o), jv(d), FLT_MAX, pm.nodes, mx.gblocks, mx.tri_geom,
        pm.cl_first, pm.width, T_MIN, center=mx.center, passes=passes,
        interpret=True, smem_nodes=pm.smem_nodes, top_rows=pm.top_rows,
        nodes_top=pm.nodes_top)
    tk, tri, _ = cmx.mx_trace(tv(o), tv(d), FLT_MAX, tabs, T_MIN, passes)
    _, exact, _ = cb.heap_trace(tv(o), tv(d), FLT_MAX, tabs.heap, T_MIN)
    jtri, tri, exact = np.asarray(jouts[1]), tri.numpy(), exact.numpy()
    hits = int((exact >= 0).sum())
    assert hits > 2000
    vs_jax, departs = tri != jtri, tri != exact
    assert vs_jax.sum() <= 0.005 * tri.size
    assert departs.sum() <= {3: 0.02, 6: 0.005}[passes] * hits
    assert ((jtri != exact) == departs)[~vs_jax].all()
    lanes = vs_jax | departs
    near = np.full(lanes.sum(), np.inf)
    for ids in (exact[lanes], tri[lanes], jtri[lanes]):
        m = _edge_times_cos(jm, o[lanes], d[lanes], np.maximum(ids, 0))
        near = np.where(ids >= 0, np.minimum(near, m), near)
    assert (near <= MISJUDGED).all()
    outs = cmx.exact_winner(tv(o), tv(d), tk, torch.from_numpy(tri),
                            tabs.heap.tri_feat)
    keep = ~vs_jax
    assert_hits_match_jax(jm, o[keep], d[keep],
                          [np.asarray(x)[keep] for x in jouts],
                          [x[torch.from_numpy(keep)] for x in outs])
