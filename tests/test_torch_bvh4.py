"""The port's SAH BVH4 tables and its plain BVH4 walk (ops/bvh4.py,
ops/cuda_bvh4.py) against the JAX package: the tables element for element,
the tier decisions, and the hits of the JAX BVH4 kernels
(``packet_trace4`` / ``packet_occluded4``) in interpret mode.

Tolerances. Tables, tiers and integer outputs are exact. t: rtol 2e-6,
u and v: atol 1e-5, the normal: rtol 2e-6 and atol 1e-6, tu and tv: atol
1e-5 (the bounds of the JAX package's own BVH4 tests): XLA contracts
multiply-adds into FMAs on the CPU and PyTorch does not, which moves t by
a few ulps and u, v by the 1/a amplification of a dot product's ulp.
Winner ids agree except where two triangles give the same t (a tie the
two traversal orders break differently, ROADMAP C-3).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpu_pathtracer.models import shapes as jshapes
from tpu_pathtracer.ops import bvh as jbvh
from tpu_pathtracer.ops import bvh4 as jb4
from tpu_pathtracer.ops.pallas_bvh4 import packet_occluded4, packet_trace4
from tpu_pathtracer.ops.v3 import V3 as JV3
from tpu_pathtracer_torch.models import shapes as tshapes
from tpu_pathtracer_torch.ops import bvh as tbvh
from tpu_pathtracer_torch.ops import bvh4 as tb4
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh4 as cb4
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX
import bvh4_cases

T_MIN = 1e-3


def soup(t, seed):
    rng = np.random.RandomState(seed)
    base = rng.uniform(-10, 10, (t, 3)).astype(np.float32)
    v1 = base + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v2 = base + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    tc = rng.rand(t, 6).astype(np.float32)
    mid = rng.randint(0, 5, t).astype(np.int32)
    return base, v1, v2, tc, mid


def rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.uniform(-8, 8, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def jv(a):
    return JV3(*(jnp.asarray(a[:, k]) for k in range(3)))


def tv(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                for k in range(3)))


def both_meshes(t, seed, ppl=16):
    arrays = soup(t, seed)
    return (jbvh.build_bvh(*arrays, prims_per_leaf=ppl, bvh4=False),
            tbvh.build_bvh(*arrays, prims_per_leaf=ppl, bvh4=False,
                           device="cpu"))


def tri_t(mesh, o, d, ids):
    """t of each ray against triangle ``ids`` (heap slots), float64."""
    v0 = np.asarray(mesh.v0, np.float64)[ids]
    e1 = np.asarray(mesh.v1, np.float64)[ids] - v0
    e2 = np.asarray(mesh.v2, np.float64)[ids] - v0
    n = np.cross(e1, e2)
    return ((o - v0) * n).sum(1) / -(d * n).sum(1)


def assert_ids_or_ties(mesh, o, d, got, want, hit):
    """Winner heap slots equal, except on lanes where both slots give the
    same t to float32 precision."""
    diff = hit & (got != want)
    if diff.any():
        ta = tri_t(mesh, o[diff], d[diff], got[diff])
        tb = tri_t(mesh, o[diff], d[diff], want[diff])
        np.testing.assert_allclose(ta, tb, rtol=2e-6)
    assert diff.sum() <= max(2, hit.sum() // 100)


@pytest.mark.parametrize("t", [1777, 3000])
@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("quant", [False, True])
def test_tables_equal_jax(t, width, quant):
    jm, tm = both_meshes(t, seed=t)
    j4 = jb4.attach_bvh4(jm, width=width, quant=quant).bvh4
    t4 = tb4.attach_bvh4(tm, width=width, quant=quant).bvh4
    assert t4.quant == j4.quant == quant
    for k in ("bounds", "refs", "tri_feat", "tri_map"):
        np.testing.assert_array_equal(getattr(t4, k).numpy(),
                                      np.asarray(getattr(j4, k)), err_msg=k)
    if quant:
        np.testing.assert_array_equal(t4.qparams.numpy(),
                                      np.asarray(j4.qparams))
    assert (t4.n_nodes, t4.width, t4.stack_cap, t4.n_clusters) == \
        (j4.n_nodes, j4.width, j4.stack_cap, j4.n_clusters)
    # the port's triangle table: the JAX blocks' rows, zero on padding
    tab = t4.tri.numpy()
    live = t4.tri_map.numpy() >= 0
    np.testing.assert_array_equal(tab[~live], 0.0)
    np.testing.assert_array_equal(tab[:, 9:12], t4.tri_feat.numpy()[:, 0:3])
    np.testing.assert_array_equal(tab[:, 0:9], t4.tri_feat.numpy()[:, 10:19])
    # build_bvh4 gives the f32 tables whatever their size
    f32 = tb4.build_bvh4(tm, width=width)
    assert torch.equal(f32.refs, t4.refs)
    if not quant:
        assert torch.equal(f32.bounds, t4.bounds)


def test_dequantized_boxes_contain_the_true_boxes():
    _, tm = both_meshes(3000, seed=11)
    f32 = tb4.attach_bvh4(tm, width=32, quant=False).bvh4
    q = tb4.attach_bvh4(tm, width=32, quant=True).bvh4
    dq = cb4.dequantize(q.bounds, q.qparams).reshape(-1, 4, 6)
    fb = f32.bounds.reshape(-1, 4, 6)
    live = f32.refs.reshape(-1, 4) != 0
    assert bool((dq[live][:, 0:3] <= fb[live][:, 0:3]).all())
    assert bool((dq[live][:, 3:6] >= fb[live][:, 3:6]).all())
    assert bool((dq[~live][:, 0:3] > dq[~live][:, 3:6]).all())


def test_tier_decisions_equal_jax():
    """knot-131k takes the f32 BVH4 tier, the dragon-class knot stays on
    the heap (the quant tier's expected-cost gate), in both packages."""
    for kw in ({}, dict(nu=1664, nv=262)):
        js, _ = jshapes.knot_zoo_scene(32, 32, **kw)
        ts, _ = tshapes.knot_zoo_scene(32, 32, device="cpu", **kw)
        assert (ts.mesh.bvh4 is None) == (js.mesh.bvh4 is None)
        assert tbvh._bvh4_auto_eligible(ts.mesh.num_tris) == \
            jbvh._bvh4_auto_eligible(js.mesh.num_tris)
        if kw:
            assert ts.mesh.bvh4 is None and ts.mesh.num_tris == 1 << 20
            continue
        assert not ts.mesh.bvh4.quant and ts.mesh.bvh4.n_nodes == 965
        for k in ("bounds", "refs", "tri_map"):
            np.testing.assert_array_equal(
                getattr(ts.mesh.bvh4, k).numpy(),
                np.asarray(getattr(js.mesh.bvh4, k)), err_msg=k)


@pytest.mark.parametrize("quant", [False, True])
def test_plain_walk_matches_jax_kernels(quant):
    """Nearest hit and features of the plain BVH4 walk against
    ``packet_trace4`` in interpret mode, and any-hit against
    ``packet_occluded4`` with a per-lane t_max and dead lanes."""
    jm, tm = both_meshes(2000, seed=0)
    j4 = jb4.attach_bvh4(jm, width=32, quant=quant).bvh4
    t4 = tb4.attach_bvh4(tm, width=32, quant=quant).bvh4
    o, d = rays(600, seed=1)
    (jt, jtri, ju, jvv, jnx, jny, jnz, jtu, jtv, jmid), _ = packet_trace4(
        jv(o), jv(d), FLT_MAX, j4.bounds, j4.refs, j4.blocks, j4.tri_feat,
        j4.width, T_MIN, j4.stack_cap, interpret=True, quant=quant,
        qparams=j4.qparams)
    tabs = cb4.bvh4_tables(t4)
    t, tri, cnt = cb4.bvh4_trace(tv(o), tv(d), FLT_MAX, tabs, T_MIN)
    t, tri, u, v, nx, ny, nz, tu, tvv, mid = cb.winner_features(
        tv(o), tv(d), t, tri, tabs.tri_feat)
    jtri, tri = np.asarray(jtri), tri.numpy()
    hit = jtri >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    assert hit.sum() > 100
    tmap = t4.tri_map.numpy()
    assert_ids_or_ties(jm, o, d, tmap[np.maximum(tri, 0)],
                       tmap[np.maximum(jtri, 0)], hit)
    same = hit & (tri == jtri)
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(jt)[hit],
                               rtol=2e-6)
    np.testing.assert_array_equal(t.numpy()[~hit], np.float32(FLT_MAX))
    for a, b in ((u, ju), (v, jvv), (tu, jtu), (tvv, jtv)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   atol=1e-5)
    for a, b in ((nx, jnx), (ny, jny), (nz, jnz)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   rtol=2e-6, atol=1e-6)
    np.testing.assert_array_equal(mid.numpy()[same], np.asarray(jmid)[same])
    # counters: per ray, positive, leaf_pop <= leaf_visits
    tot = cnt.sum(1, dtype=torch.int64)
    assert tot[0] > 0 and tot[2] > 0 and tot[4] >= tot[0] + tot[1]
    assert bool((cnt[3] <= cnt[2]).all()) and bool((cnt >= 0).all())

    tmv = np.where(np.arange(600) % 3 == 0, -1.0, 9.0).astype(np.float32)
    for tmax in (12.0, tmv):
        jocc, _ = packet_occluded4(
            jv(o), jv(d), jnp.asarray(tmax), j4.bounds, j4.refs, j4.blocks,
            j4.width, T_MIN, j4.stack_cap, interpret=True, quant=quant,
            qparams=j4.qparams)
        occ, ocnt = cb4.bvh4_occluded(tv(o), tv(d), torch.as_tensor(tmax),
                                      tabs, T_MIN)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
        if isinstance(tmax, np.ndarray):
            # dead lanes test nothing
            assert bool((ocnt[:, torch.from_numpy(tmax <= 0)] == 0).all())


def test_stack_overflow_raises():
    """A ref stack too small for the tree raises in the plain walk, and
    the kernel's wrapper refuses tables beyond its compiled capacity
    before it touches a device."""
    _, tm = both_meshes(2000, seed=2)
    tabs = cb4.bvh4_tables(tb4.build_bvh4(tm, width=32))
    o, d = rays(200, seed=3)
    with pytest.raises(RuntimeError, match="overflow"):
        cb4.bvh4_trace(tv(o), tv(d), FLT_MAX, tabs._replace(stack_cap=1),
                       T_MIN)
    big = tabs._replace(stack_cap=cb4.STACK_CAPACITY + 1)
    with pytest.raises(ValueError, match="stack"):
        cb4._launch(cb4._NEAREST, tv(o), tv(d),
                    torch.full((200,), FLT_MAX), big, T_MIN)
    # the tables' own bound is enough
    cb4.bvh4_trace(tv(o), tv(d), FLT_MAX, tabs, T_MIN)
    cb4.check_stack(tabs)
    # the flag a kernel sets on the card makes check_stack raise
    flagged = tabs._replace(overflow=torch.ones_like(tabs.overflow))
    with pytest.raises(RuntimeError, match="overflow"):
        cb4.check_stack(flagged)


def test_launch_refuses_misaligned_tables():
    """The kernel reads bounds as float4 and refs as int4: the wrapper
    refuses tables that are not 16-byte aligned before it touches a
    device."""
    _, tm = both_meshes(2000, seed=2)
    tabs = cb4.bvh4_tables(tb4.build_bvh4(tm, width=32))
    o, d = rays(8, seed=3)
    for name in ("bounds", "refs"):
        a = getattr(tabs, name)
        shifted = torch.cat([a[:1], a])[1:]  # the same values, 4 B off
        assert torch.equal(shifted, a) and shifted.data_ptr() % 16
        with pytest.raises(ValueError, match="aligned"):
            cb4._launch(cb4._NEAREST, tv(o), tv(d), torch.full((8,), 9.0),
                        tabs._replace(**{name: shifted}), T_MIN)


def test_convert_carries_bvh4_tables():
    """A JAX mesh with BVH4 tables converts to the port's, with the
    port's own triangle table."""
    from test_torch_render import jax_fields
    from tpu_pathtracer_torch.convert import mesh_from_numpy
    jm, tm = both_meshes(1777, seed=5)
    for quant in (False, True):
        j4m = jb4.attach_bvh4(jm, width=32, quant=quant)
        got = mesh_from_numpy(jax_fields(j4m), "cpu").bvh4
        want = tb4.attach_bvh4(tm, width=32, quant=quant).bvh4
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, torch.Tensor):
                assert torch.equal(a, b), f.name
            else:
                assert a == b, f.name


def case_tables(c):
    """A contract case's tables in both packages: (the JAX package's
    Bvh4Data, the port's)."""
    if c.tree is not None:
        args = bvh4_cases.assemble_args(c.tree)
        return jb4._assemble4(*args), tb4._assemble4(*args, "cpu")
    arrays = bvh4_cases.soup(c.soup["t"], c.soup["seed"])
    jm = jbvh.build_bvh(*arrays, prims_per_leaf=16, bvh4=False)
    tm = tbvh.build_bvh(*arrays, prims_per_leaf=16, bvh4=False,
                        device="cpu")
    kw = dict(width=c.soup["width"], quant=c.soup["quant"])
    return (jb4.attach_bvh4(jm, **kw).bvh4,
            tb4.attach_bvh4(tm, **kw).bvh4)


def slot_t(tab, o, d, ids):
    """t of each ray against SAH slots ``ids`` of the [S, 12] triangle
    table, float64."""
    rows = tab[ids].astype(np.float64)
    v0, n = rows[:, 0:3], rows[:, 9:12]
    return ((o - v0) * n).sum(1) / -(d * n).sum(1)


@pytest.mark.parametrize("name", bvh4_cases.CASES)
def test_contract_cases_match_jax_kernels(name):
    """The contract's edge cases (tests/bvh4_cases.py): the plain walk's
    nearest hit against ``packet_trace4`` and its occlusion against
    ``packet_occluded4`` in interpret mode (t to rtol 2e-6, winners equal
    except exact ties between the two walks' orders), and each case's own
    check of the walk: winners, t, occlusion and counters. Where the case
    knows its deepest stack, the walk passes at exactly that stack_cap
    and raises at one less."""
    c = bvh4_cases.case(name)
    j4, t4 = case_tables(c)
    assert t4.quant == bool(c.soup and c.soup["quant"])
    tabs = cb4.bvh4_tables(t4)
    o, d, tmax = tv(c.o), tv(c.d), torch.from_numpy(c.t_max)
    t, tri, cnt = cb4.bvh4_trace(o, d, tmax, tabs, bvh4_cases.T_MIN)
    occ, ocnt = cb4.bvh4_occluded(o, d, tmax, tabs, bvh4_cases.T_MIN)
    t, tri, occ = t.numpy(), tri.numpy(), occ.numpy()
    c.check(t, tri, occ, cnt.numpy())
    # any-hit walks the nearest walk's steps up to its first hit
    assert bool((ocnt <= cnt).all())
    if name in bvh4_cases.NOT_JAX:
        return

    kw = dict(interpret=True, quant=j4.quant, qparams=j4.qparams)
    (jt, jtri, *_), _ = packet_trace4(
        jv(c.o), jv(c.d), jnp.asarray(c.t_max), j4.bounds, j4.refs,
        j4.blocks, j4.tri_feat, j4.width, bvh4_cases.T_MIN, j4.stack_cap,
        **kw)
    jt, jtri = np.asarray(jt), np.asarray(jtri)
    hit = jtri >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=2e-6)
    diff = hit & (tri != jtri)
    tab = tabs.tri.numpy()
    np.testing.assert_allclose(slot_t(tab, c.o[diff], c.d[diff], tri[diff]),
                               slot_t(tab, c.o[diff], c.d[diff],
                                      jtri[diff]), rtol=2e-6)
    jocc, _ = packet_occluded4(
        jv(c.o), jv(c.d), jnp.asarray(c.t_max), j4.bounds, j4.refs,
        j4.blocks, j4.width, bvh4_cases.T_MIN, j4.stack_cap, **kw)
    np.testing.assert_array_equal(occ, np.asarray(jocc))

    if c.need is not None:
        assert t4.stack_cap > c.need
        exact = tabs._replace(stack_cap=c.need)
        t2, tri2, cnt2 = cb4.bvh4_trace(o, d, tmax, exact,
                                        bvh4_cases.T_MIN)
        assert torch.equal(cnt2, cnt) and np.array_equal(tri2.numpy(), tri)
        with pytest.raises(RuntimeError, match="overflow"):
            cb4.bvh4_trace(o, d, tmax, tabs._replace(stack_cap=c.need - 1),
                           bvh4_cases.T_MIN)
