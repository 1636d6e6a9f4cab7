"""The walk probes of the port (``tpu_pathtracer_torch/experiments``):
K13's three ablated heap walks (``iter_ablate``) and K16's node phase
(``dual_probe``), their plain versions against the JAX probes' TPU
kernels in interpret mode (``experiments/iter_ablate.py``
``_kernel_ablate`` and ``experiments/dual_probe.py`` ``_kernel``), on a
small knot (32,768 triangles, 64 a leaf) and 4096 primary rays.

The TPU kernels walk a 1024-ray packet as one: a child is entered if any
lane's slab test enters it. Child boxes nest inside their parent's and
closest is fixed, so a packet visits exactly the union of its lanes' own
walks, and each of its counts is exact against the port's per-ray walks:
``nl`` is the number of distinct leaves in the union, ``nb`` the number of
interior nodes in the union with a child in the union, and the node
phase's steps the number of interior nodes in the union. Tolerances: the
counts exact; ``full``'s acc (t summed over accepted slots) rtol 1e-5
(the leaf order differs and XLA contracts multiply-adds, ROADMAP C-2),
except on a lane that accepts a triangle in a leaf of its packet's union
that its own walk never enters (a grazing hit its slab test rounds away):
such lanes are named, their acc must equal the port's plus those leaves'
accepted t, and there are at most 0.1% of them. ``nomt``'s acc is held
against the blocks' element 0 summed over the union, within the float32
recursive-summation bound (terms x 2^-24 x the sum of magnitudes: the
kernel adds in its visit order); the port's ``nomt`` xor against the
visited leaves' words, exactly.

The script-style TPU probe ``iter_ablate.py`` builds a scene and times at
import, so only its kernel function is compiled from the file's source;
``dual_probe.py`` guards its ``main()`` and is imported by its path. The
CUDA kernels run only on a card: ``tests/test_torch_cuda.py`` holds them
bit for bit against these plain versions. Beside the JAX comparisons:
``full``'s per-leaf sum in the kernel's 16-lane tree order (leaves 5, 33
and 64 wide), the modes' counters at the dragon pool's 196,608 rays, and
``mode_sass``, the SASS counter of K13's issue-rate floor, on a listing
written out by hand (``sass_listing.py``).
"""

import ast
import functools
import importlib.util
import os
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sass_listing import listing
from test_torch_bvh4 import tv
from tpu_pathtracer.models import shapes as jshapes
from tpu_pathtracer.ops import pallas_bvh as pb
from tpu_pathtracer_torch.experiments import dual_probe as dp
from tpu_pathtracer_torch.experiments import iter_ablate as ia
from tpu_pathtracer_torch.models import shapes as tshapes
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops.vec import FLT_MAX
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "experiments")
KNOT = dict(nu=256, nv=64, prims_per_leaf=64)
SIDE = 64  # 4096 primary rays: four 1024-ray packets
PACKET = 1024
ACC_RTOL = 1e-5
GRAZING_SHARE = 1e-3


def _load_by_path(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXP, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_defs(name, names, namespace):
    """The functions ``names`` of ``experiments/<name>.py``, compiled
    alone into ``namespace`` (the file runs a probe at import)."""
    path = os.path.join(EXP, f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in body} == set(names)
    exec(compile(ast.Module(body, []), path, "exec"), namespace)
    return namespace


@pytest.fixture(scope="module")
def knot():
    js, jc = jshapes.knot_zoo_scene(SIDE, SIDE, **KNOT)
    ts, _ = tshapes.knot_zoo_scene(SIDE, SIDE, device="cpu", **KNOT)
    for k in ("v0", "v1", "v2", "bvh_min", "bvh_max"):
        np.testing.assert_array_equal(getattr(ts.mesh, k).numpy(),
                                      np.asarray(getattr(js.mesh, k)))
    pm = pb.build_packet_mesh(js.mesh, max_width=64)
    tabs = cb.heap_tables(ts.mesh)
    assert (pm.cl_first, pm.width, pm.cpb) == (tabs.first_leaf, 64, 1)
    assert pm.smem_nodes and not pm.quant
    n = SIDE * SIDE
    o, d = jc.generate_rays(jnp.arange(n, dtype=jnp.uint32),
                            jnp.zeros((n,), jnp.uint32), SIDE, SIDE)
    o = np.stack([np.asarray(c) for c in o], 1)
    d = np.stack([np.asarray(c) for c in d], 1)
    return types.SimpleNamespace(mesh=ts.mesh, pm=pm, tabs=tabs, o=o, d=d,
                                 n=n)


def lane_walks(fn):
    """Runs ``fn``, a plain walk through ``cuda_bvh.HeapWalk``, and
    returns (its result, [S, 2] (lane, interior node) of every step,
    [V, 2] (lane, leaf) of every leaf visit)."""
    steps, leaves = [], []
    real_step, real_leaf = cb.HeapWalk.node_step, cb.HeapWalk.visit_leaf

    def node_step(self, inner):
        steps.append(torch.stack([inner, self.idx[inner]], 1))
        return real_step(self, inner)

    def visit_leaf(self, leaf):
        leaves.append(torch.stack(
            [leaf, self.idx[leaf] - self.tabs.first_leaf], 1))
        return real_leaf(self, leaf)

    with mock.patch.object(cb.HeapWalk, "node_step", node_step), \
            mock.patch.object(cb.HeapWalk, "visit_leaf", visit_leaf):
        out = fn()
    return out, torch.cat(steps).numpy(), torch.cat(leaves).numpy()


def unions(steps, leaves, n, first_leaf, size=PACKET):
    """Per ``size``-lane packet: (interior nodes of the union, leaves of
    the union, interior nodes of the union with a child in it)."""
    out = []
    for p in range(n // size):
        nodes = np.unique(steps[steps[:, 0] // size == p, 1])
        lv = np.unique(leaves[leaves[:, 0] // size == p, 1])
        union = np.union1d(nodes, lv + first_leaf)
        entered = np.isin(2 * nodes, union) | np.isin(2 * nodes + 1, union)
        out.append((nodes, lv, int(entered.sum())))
    return out


def _rays_2d(knot):
    return [jnp.asarray(knot.o[:, k].reshape(-1, 128)) for k in range(3)] + \
        [jnp.asarray(knot.d[:, k].reshape(-1, 128)) for k in range(3)]


def _jax_ablate(knot, mode):
    """``iter_ablate.py``'s kernel in interpret mode with the specs of its
    ``trace_ablate`` (:136-150): (acc [n], nb and nl per packet)."""
    ns = _kernel_defs("iter_ablate", {"_kernel_ablate"}, dict(
        jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, _node_bounds=pb._node_bounds,
        _slab=pb._slab, _advance=pb._advance, _ctz32=pb._ctz32,
        _mt_scalar_tri=pb._mt_scalar_tri))
    pm, n = knot.pm, knot.n
    ray = pl.BlockSpec((pb.ROWS, 128), lambda i: (i, 0),
                       memory_space=pltpu.VMEM)
    hbm = pl.BlockSpec(memory_space=pltpu.HBM)
    acc, cnt = pl.pallas_call(
        functools.partial(ns["_kernel_ablate"], cl_first=pm.cl_first,
                          width=pm.width, stride=pm.stride, t_min=ia.T_MIN,
                          mode=mode),
        grid=(n // PACKET,), in_specs=[ray] * 7 + [hbm, hbm],
        out_specs=(ray, ray),
        out_shape=(jax.ShapeDtypeStruct((n // 128, 128), jnp.float32),
                   jax.ShapeDtypeStruct((n // 128, 128), jnp.int32)),
        interpret=True,
    )(*_rays_2d(knot), jnp.full((n // 128, 128), FLT_MAX, jnp.float32),
      pm.nodes, pm.blocks)
    cnt = np.asarray(cnt)
    return np.asarray(acc).reshape(-1), cnt[::pb.ROWS, 0], cnt[::pb.ROWS, 1]


def _accepted_t_sum(knot, lane, leaves):
    """t summed over the slots of ``leaves`` that ``lane`` accepts, its
    closest held at FLT_MAX (float64 sum of the plain version's t)."""
    P = knot.tabs.prims_per_leaf
    ids = torch.as_tensor((leaves[:, None] * P + np.arange(P)).ravel())
    rows = knot.tabs.tri[ids][None]
    o = torch.from_numpy(knot.o[lane:lane + 1])
    d = torch.from_numpy(knot.d[lane:lane + 1])
    t, ok = cb.mt_rows(rows, o, d, ia.T_MIN, torch.full((1,), FLT_MAX))
    return float(t[ok].double().sum())


@pytest.mark.parametrize("mode", ia.MODES)
def test_ablate_matches_jax_packet_union(knot, mode):
    n = knot.n
    (acc, cnt), steps, leaves = lane_walks(lambda: ia.ablate_trace(
        tv(knot.o), tv(knot.d), FLT_MAX, knot.tabs, ia.T_MIN, mode))
    assert cnt.shape == (5, n) and int(cnt[3].sum()) == 0
    np.testing.assert_array_equal(cnt[2].numpy(),
                                  np.bincount(leaves[:, 0], minlength=n))
    jacc, jnb, jnl = _jax_ablate(knot, mode)
    un = unions(steps, leaves, n, knot.tabs.first_leaf)
    np.testing.assert_array_equal(jnl, [len(lv) for _, lv, _ in un])
    np.testing.assert_array_equal(jnb, [nb for *_, nb in un])
    # the test can fail: some packet's union leaves part of the tree out
    assert any(0 < len(lv) < knot.tabs.first_leaf for _, lv, _ in un)
    if mode == "noleaf":
        assert not jacc.any() and not acc.any()
    elif mode == "nomt":
        # the kernel adds in float32 in its visit order: within the
        # recursive-summation bound, terms x 2^-24 x the sum of |x|
        blk0 = np.asarray(knot.pm.blocks)[:, 0, 0].astype(np.float64)
        for p, (_, lv, _) in enumerate(un):
            got = jacc[p * PACKET:(p + 1) * PACKET]
            assert (got == got[0]).all()
            bound = len(lv) * 2.0 ** -24 * np.abs(blk0[lv]).sum()
            assert abs(got[0] - blk0[lv].sum()) <= bound
    else:
        acc = acc.numpy()
        off = ~np.isclose(jacc, acc, rtol=ACC_RTOL, atol=0.0)
        grazing = []
        for lane in np.flatnonzero(off):
            own = leaves[leaves[:, 0] == lane, 1]
            extra = np.setdiff1d(un[lane // PACKET][1], own)
            more = _accepted_t_sum(knot, lane, extra)
            assert more > 0 and np.isclose(jacc[lane], acc[lane] + more,
                                           rtol=ACC_RTOL), \
                f"lane {lane}: JAX {jacc[lane]} port {acc[lane]} extra {more}"
            grazing.append(int(lane))
        assert len(grazing) <= GRAZING_SHARE * n, \
            f"{len(grazing)} lanes hit in a leaf they never enter: {grazing}"
        assert (acc > 0).sum() > 100


def test_nomt_folds_every_visited_row(knot):
    """``nomt``'s acc is the xor of the words of every leaf the ray
    visits; ``noleaf`` and ``full`` visit the same leaves."""
    (bits, cnt), _, leaves = lane_walks(lambda: ia.ablate_trace(
        tv(knot.o), tv(knot.d), FLT_MAX, knot.tabs, ia.T_MIN, "nomt"))
    words = knot.tabs.tri[:knot.tabs.first_leaf * 64].numpy().view(
        np.int32).reshape(knot.tabs.first_leaf, -1)
    want = np.zeros(knot.n, np.int32)
    for lane, leaf in leaves:
        want[lane] ^= np.bitwise_xor.reduce(words[leaf])
    assert bits.dtype == torch.int32 and (want != 0).sum() > 100
    np.testing.assert_array_equal(bits.numpy(), want)
    for mode in ("full", "noleaf"):
        _, c = ia.ablate_trace(tv(knot.o), tv(knot.d), FLT_MAX, knot.tabs,
                               ia.T_MIN, mode)
        assert torch.equal(c, cnt)


@pytest.mark.parametrize("packets", [1, 2, 4])
def test_dual_steps_match_jax_packet_union(knot, packets):
    """Per block of the TPU kernel, the interior steps of its packets:
    the interior nodes of each packet's union, summed."""
    dpm = _load_by_path("dual_probe")
    n, pm = knot.n, knot.pm
    steps, walked, _ = lane_walks(lambda: dp.dual_steps(
        tv(knot.o), tv(knot.d), knot.tabs, 1))
    rows = 8 * packets
    spec = pl.BlockSpec((rows, 128), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(dpm._kernel, cl_first=pm.cl_first, P=packets),
        grid=(n // (rows * 128),),
        in_specs=[spec] * 6 + [pl.BlockSpec(memory_space=pltpu.HBM)],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((n // 128, 128), jnp.int32),
        interpret=True)(*_rays_2d(knot), pm.nodes)
    per_packet = [len(nodes) for nodes, _, _ in
                  unions(walked, np.zeros((0, 2), np.int64), n,
                         knot.tabs.first_leaf)]
    want = np.add.reduceat(per_packet, np.arange(0, len(per_packet),
                                                 packets))
    np.testing.assert_array_equal(np.asarray(out)[::rows, 0], want)
    np.testing.assert_array_equal(steps.numpy(),
                                  np.bincount(walked[:, 0], minlength=n))
    assert 0 < max(per_packet) < knot.tabs.first_leaf - 1


def test_dual_steps_are_the_walks_node_steps(knot):
    """R only schedules: on the CPU every R is the plain version, and its
    counts are the node steps of the ablated walk (closest at FLT_MAX)."""
    _, cnt = ia.ablate_trace(tv(knot.o), tv(knot.d), FLT_MAX, knot.tabs,
                             ia.T_MIN, "noleaf")
    for r in dp.RAYS_PER_THREAD:
        assert torch.equal(dp.dual_steps(tv(knot.o), tv(knot.d), knot.tabs,
                                         r), cnt[4])
    with pytest.raises(ValueError, match="R must be"):
        dp.dual_steps(tv(knot.o), tv(knot.d), knot.tabs, 3)


def test_bounce_rays_equal_jax_generator(knot):
    """``dual_probe.bounce_rays`` is ``experiments/incoh_phase.py``'s
    generator before its sort, value for value."""
    inc = _load_by_path("incoh_phase")
    js, _ = jshapes.knot_zoo_scene(SIDE, SIDE, **KNOT)
    with mock.patch.object(inc, "n", 4096), \
            mock.patch.object(inc, "sort_rays", lambda s, o, d: (o, d)):
        jo, jd = inc.bounce_rays(js)
    o, d = dp.bounce_rays(knot.mesh, 4096)
    np.testing.assert_array_equal(o, np.stack([np.asarray(c) for c in jo], 1))
    np.testing.assert_array_equal(d, np.stack([np.asarray(c) for c in jd], 1))
    assert np.isfinite(o).all() and o.dtype == np.float32


def test_cpu_tensors_take_the_plain_version(knot):
    before = dict(ia.LAUNCHES), dict(dp.LAUNCHES)
    o, d = tv(knot.o[:256]), tv(knot.d[:256])
    for mode in ia.MODES:
        ia.ablate_trace(o, d, FLT_MAX, knot.tabs, ia.T_MIN, mode)
    dp.dual_steps(o, d, knot.tabs, 2)
    assert (ia.LAUNCHES, dp.LAUNCHES) == before
    with pytest.raises(ValueError, match="mode"):
        ia.ablate_trace(o, d, FLT_MAX, knot.tabs, ia.T_MIN, "mt")


def _tree_sum(t, ok, lanes):
    """One leaf visit's sum as the kernel forms it, written out in float32
    numpy: lane s adds the accepted t of slots s, s + lanes, ... in slot
    order from 0; then the lanes' partials are added pairwise, neighbours
    first (offsets 1, 2, 4, 8)."""
    part = [np.float32(0)] * lanes
    for k in range(len(t)):
        if ok[k]:
            part[k % lanes] = np.float32(part[k % lanes] + np.float32(t[k]))
    while len(part) > 1:
        part = [np.float32(part[i] + part[i + 1])
                for i in range(0, len(part), 2)]
    return part[0]


def test_leaf_lanes_are_the_kernels():
    src = open(os.path.join(ROOT, "tpu_pathtracer_torch", "csrc",
                            "iter_ablate.cu")).read()
    assert f"constexpr int kLeafLanes = {ia.LEAF_LANES};" in src


@pytest.mark.parametrize("width", [5, 33, 64])
def test_full_sums_a_leaf_in_the_kernels_tree_order(width):
    """``leaf_sums`` on leaves 5 and 33 wide (no multiple of the pair's 16
    lanes: the tail lanes test nothing) and 64 wide: bit-equal to the
    16-lane tree order written out, not to the slot-by-slot sum."""
    rng = np.random.RandomState(width)
    t = rng.uniform(0.5, 40, (64, width)).astype(np.float32)
    ok = rng.uniform(size=(64, width)) < 0.6
    ok[0] = True
    got = ia.leaf_sums(torch.from_numpy(t), torch.from_numpy(ok)).numpy()
    want = np.array([_tree_sum(t[m], ok[m], ia.LEAF_LANES)
                     for m in range(64)], np.float32)
    np.testing.assert_array_equal(got, want)
    serial = [np.float32(0)] * 64
    for m in range(64):
        for k in range(width):
            if ok[m, k]:
                serial[m] = np.float32(serial[m] + t[m, k])
    assert (got != np.array(serial, np.float32)).any()


def test_full_adds_each_visit_in_tree_order():
    """``full`` on a 33-wide leaf mesh: each ray's acc is its visits'
    tree-order sums (``_tree_sum`` of the plain Moller-Trumbore t),
    added in visit order."""
    kw = dict(KNOT, prims_per_leaf=33)
    ts, cam = tshapes.knot_zoo_scene(32, 32, device="cpu", **kw)
    tabs = cb.heap_tables(ts.mesh)
    o, d = cam.generate_rays(torch.arange(1024), 0, 32, 32)
    (acc, _), _, leaves = lane_walks(lambda: ia.ablate_trace(
        o, d, FLT_MAX, tabs, ia.T_MIN, "full"))
    want = np.zeros(1024, np.float32)
    slots = torch.arange(33)
    for lane, leaf in leaves:
        rows = tabs.tri[leaf * 33 + slots][None]
        t, ok = cb.mt_rows(rows, torch.stack([c[lane] for c in o])[None],
                           torch.stack([c[lane] for c in d])[None],
                           ia.T_MIN, torch.full((1,), FLT_MAX))
        want[lane] = np.float32(want[lane] + _tree_sum(
            t[0].numpy(), ok[0].numpy(), ia.LEAF_LANES))
    assert (want > 0).sum() > 50
    np.testing.assert_array_equal(acc.numpy(), want)


def test_modes_visit_alike_at_the_pool_ray_count():
    """At the dragon frame's 196,608-lane pool (a 512x384 grid of the
    small knot's camera), the three modes' counters are equal, with
    closest at t_max and at the walk's hit t."""
    ts, cam = tshapes.knot_zoo_scene(512, 384, device="cpu", **KNOT)
    tabs = cb.heap_tables(ts.mesh)
    n = 3 << 16
    o, d = cam.generate_rays(torch.arange(n), 0, 512, 384)
    hit_t = cb._heap_trace_ref(o, d, torch.full((n,), FLT_MAX), tabs,
                               ia.T_MIN)[0]
    for t_max in (FLT_MAX, hit_t):
        cnts = [ia.ablate_trace(o, d, t_max, tabs, ia.T_MIN, m)[1]
                for m in ia.MODES]
        assert cnts[0].shape == (5, n) and int(cnts[0][2].sum()) > n // 10
        assert all(torch.equal(c, cnts[0]) for c in cnts[1:])


def test_mode_sass_counts_a_slot_a_step_and_a_round():
    """``mode_sass`` on a listing of the walk's shape: the walk loop holds
    the leaf phase's loop, which holds the slot loop; the division's slow
    path (a forward branch over a CALL) counts nowhere."""
    slot = (["slot:"] + ["LDG.E.128.CONSTANT R4, desc[UR4][R16.64]"] * 3
            + ["MUFU.RCP R0, R49", "@!P1 BRA {fast}", "MOV R16, 0x0",
               "CALL.REL.NOINC {div}", "fast:"]
            + ["FADD R9, R46, -R9"] * 10
            + ["ISETP.GE.AND P1, PT, R39, UR10, PT", "@!P1 BRA {slot}"])
    leaf = (["leaf:"] + ["SHFL.IDX PT, R45, R24, R2, 0x1f"] * 8
            + ["LOP3.LUT R7, R48, R7, RZ, 0x30, !PT"] * 5 + slot
            + ["SHFL.BFLY PT, R3, R50, 0x1, 0x1f"] * 4
            + ["SHFL.IDX PT, R4, R2, R47, 0x1f", "VOTE.ANY R0, PT, P0",
               "@P0 BRA {leaf}"])
    walk = (["walk:", "VOTE.ANY R3, PT, P0", "VOTE.ANY R48, PT, P1",
             "@!P2 BRA {done}", "@P1 BRA {node}"] + leaf
            + ["BRA {tail}", "node:"]
            + ["LDG.E.128.CONSTANT R4, desc[UR4][R14.64]"] * 4
            + ["FADD R17, -R24, R4"] * 20
            + ["tail:", "ISETP.NE.AND P0, PT, R31, RZ, PT",
               "VOTE.ANY R48, PT, P1", "@P2 BRA {walk}"])
    text = listing("_ZN4anon13ablate_kernelILi0EEEvPKf",
                   ["LDC R1, c[0x0][0x28]"] * 3 + walk
                   + ["done:", "EXIT", "div:", "RET.REL.NODEC R2 0x0",
                      "trap:", "BRA {trap}"])
    # slot: 19 - 2 slow; round: 39 - 2 slow - 17; node: 71 - 2 slow - 37
    assert ia.mode_sass(text) == {"full": (17, 32, 20)}
    cnt = torch.tensor([[0], [0], [3], [0], [10]])
    ms, ins = ia.issue_floor((17, 32, 20), cnt, 64)
    assert ins == (3 * (64 * 17 + 16 * 20) + 10 * 32) // 32


DUAL_KERNEL = "_ZN12_GLOBAL__N_111dual_kernelILi{r}EEEvPKfS2_S2_S2_S2_S2_PK6float4jiPiS6_"


def _dual_listing(r, atom=True):
    """A walk loop of K16's shape: the refill round (a ballot, lane 0's
    atomic, the index's shuffle and a division with its slow path) skipped
    when no lane wants a ray, then the slots' loads, each slot's seat (a
    fresh ray's load and reciprocal, its slow path) skipped when it holds
    none, the slots' tests and the warp's vote to go on."""
    refill = (["VOTE.ANY R5, PT, P0", "ISETP.NE.AND P1, PT, R5, RZ, PT",
               "@!P1 BRA {issue}", "@!P2 BRA {noatom}"]
              + (["ATOMG.E.ADD.STRONG.GPU PT, R7, desc[UR4][R2.64], R6"]
                 if atom else ["IADD3 R7, R7, 0x1, RZ"])
              + ["noatom:", "SHFL.IDX PT, R7, R7, RZ, 0x1f",
                 "MUFU.RCP R9, R8", "@!P3 BRA {fast}",
                 "CALL.REL.NOINC {div}", "fast:", "FADD R11, R9, R9"])
    seats = sum(([f"@!P5 BRA {{seated{k}}}", "LDG.E.CONSTANT R30, "
                  "desc[UR4][R2.64]", "MUFU.RCP R31, R30",
                  f"@!P3 BRA {{fast{k}}}", "CALL.REL.NOINC {div}",
                  f"fast{k}:", "FFMA R31, R31, R30, R31", f"seated{k}:"]
                 for k in range(r)), [])
    slots = (["issue:"] + ["LDG.E.128.CONSTANT R12, desc[UR4][R14.64]"] * 4 * r
             + seats + ["FADD R17, -R24, R12"] * 9 * r
             + ["FMNMX R18, R17, R12, PT"] * r)
    return listing(DUAL_KERNEL.format(r=r),
                   ["LDC R1, c[0x0][0x28]", "loop:"] + refill + slots
                   + ["VOTE.ANY R10, PT, P4", "@P4 BRA {loop}", "EXIT",
                      "div:", "RET.REL.NODEC R2 0x0", "trap:", "BRA {trap}"])


def test_walk_sass_counts_the_walk_loop():
    """``walk_sass`` on listings of each R form: the loop that holds the
    refill's atomic, split at the branch after its ballot into a pass and
    the refill it jumps over, and each slot's seat (a stretch with a
    reciprocal and no slab test) out of the pass, each counted once but
    the division's slow path (one CALL), with its atomics; it raises on a
    form without the atomic (the first form's lockstep loop) and on a
    dump with no K16 kernel."""
    text = "".join(_dual_listing(r) for r in dp.RAYS_PER_THREAD)
    # the refill 7 less the CALL; a seat 5 less the CALL; a pass 5 (the
    # ballot's 3, the vote and the branch back) and 15 a slot (its seat's
    # branch among them)
    assert dp.walk_sass(text) == {r: (5 + 15 * r, 6, 1, 4)
                                  for r in dp.RAYS_PER_THREAD}
    with pytest.raises(ValueError, match="atomic"):
        dp.walk_sass(_dual_listing(1, atom=False))
    with pytest.raises(ValueError, match="no dual_kernel"):
        dp.walk_sass(listing("_Z5otherv", ["EXIT"]))


def test_dual_floors_and_first_form_warps():
    """The issue-rate floor is a pass for each step of each of a warp's 32
    R slots, a seat for every 32 rays and a refill round for every 32
    rays past the R x lanes that the wave seats with no refill, over the
    card's 528 schedulers; the
    latency floor the longest ray's steps, each a pass issued by one warp
    and a round trip; the first form's warps an SM follow its grid of
    n / (128 R)."""
    assert dp.issue_floor_ms((100, 60, 1, 5), 32 * 4 * 1000, 320, 4,
                             16) == pytest.approx(
        (1000 * 100 + 8 * 60 + 10 * 5) / (528 * 1.98e9) * 1e3)
    # no refill when the wave seats every ray at once
    for n, lanes in ((320, 80), (319, 80), (1, 67_584)):
        assert dp.issue_floor_ms((100, 60, 1, 5), 32 * 4 * 1000, n, 4,
                                 lanes) == pytest.approx(
            (1000 * 100 + n * 5 / 32) / (528 * 1.98e9) * 1e3)
    assert dp.latency_floor_ms((99, 60, 1, 5), 10, 200.0) == pytest.approx(
        10 * (50.0 + 200.0) / 1e6)
    # 131,072 rays: 1,024 blocks (8 an SM, 32 warps) at R = 1, 256 at 4
    assert [dp.first_form_warps(131_072, r, 132) for r in (1, 2, 4)] == [
        32, 16, 8]
    assert dp.first_form_warps(10 ** 7, 1, 132) == 64
