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

The kernel deals a leaf round's slots to the W warps of a packet and
merges them (``csrc/bvh_mr.cu``); ``split_leaf_round`` models that in
PyTorch, and the model is held bit-equal to the serial walk at W = 1, 2,
4 and 8 on the cases above and on ``tests/mr_cases.py``'s ties.
"""

import importlib.util
import os
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_bvh4 import T_MIN, assert_ids_or_ties, both_meshes, jv, \
    rays, tv
from test_torch_bvh_mx import assert_hits_match_jax
import mr_cases
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


@pytest.fixture(scope="module")
def jax_runs(jmr):
    """name: (case, packet_trace_mr's outputs and counters at FLT_MAX,
    packet_occluded_mr's occlusion at t_max 14) in interpret mode, each
    case run once."""
    runs = {}

    def run(name):
        if name not in runs:
            jm, tm, o, d = c = _case(name)
            pm = jmr.build_packet_mr(jm, max_width=32)
            jouts, jcnt = jmr.packet_trace_mr(
                jv(o), jv(d), FLT_MAX, pm.ntab, pm.blocks, pm.tri_feat,
                pm.cl_first, pm.width, pm.n_blocks, T_MIN, interpret=True)
            jocc, _ = jmr.packet_occluded_mr(
                jv(o), jv(d), 14.0, pm.ntab, pm.blocks, pm.cl_first,
                pm.width, pm.n_blocks, T_MIN, interpret=True)
            runs[name] = (c, jouts, jcnt, jocc)
        return runs[name]
    return run


@pytest.mark.parametrize("name", sorted(CASES))
def test_mr_walk_matches_jax_kernel(jax_runs, name):
    (jm, tm, o, d), jouts, jcnt, jocc = jax_runs(name)
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


# ---------------------------------------------------------------------------
# the kernel's split leaf round, modelled: W warps, then the merge
# ---------------------------------------------------------------------------

NO_KEY = 1 << 62


def split_leaf_round(W):
    """A stand-in for ``cuda_bvh_mr._leaf_round`` that computes a round
    as the kernel's W warps do: slot s of a leaf goes to warp s mod W,
    each lane tests its warp's share against the closest the round
    started with and keeps its least t, the first in (queue position,
    slot) order among equal t; the warps then merge by (t, key), key =
    (queue position, slot). Any-hit: the warps' hits OR'd, the hit lanes
    retired."""
    def leaf_round(o, d, closest, best, occ, qids, qcnt, idx, cnt, tabs,
                   t_min, any_hit, pk, visits):
        P = tabs.prims_per_leaf
        m = pk.numel()
        c0 = closest[pk].clone()                        # [m, 32]
        slots = torch.arange(P)
        bt = c0[None].repeat(W, 1, 1)                   # [W, m, 32]
        bk = torch.full((W, m, cmr.LANES), NO_KEY, dtype=torch.int64)
        hit = torch.zeros((W, m, cmr.LANES), dtype=torch.bool)
        for q in range(cmr.QUEUE):
            has = qcnt[pk] > q
            if not has.any():
                break
            cnt[2, pk[has]] += 1
            rows = tabs.tri[qids[pk, q][:, None] * P + slots]  # [m, P, 12]
            rows = rows[:, None].expand(-1, cmr.LANES, -1, -1).reshape(
                m * cmr.LANES, P, 12)
            t, ok = cb.mt_rows(rows, o[pk].reshape(-1, 3),
                               d[pk].reshape(-1, 3), t_min, c0.reshape(-1))
            t = t.view(m, cmr.LANES, P)
            ok = ok.view(m, cmr.LANES, P) & has[:, None, None]
            for w in range(W):
                mine = slots[slots % W == w]
                if mine.numel() == 0:
                    continue
                # the first minimum in slot order: the warp's strict <
                tw, j = torch.where(ok[..., mine], t[..., mine],
                                    float("inf")).min(dim=-1)
                take = tw < bt[w]  # an earlier queue position keeps a tie
                bt[w] = torch.where(take, tw, bt[w])
                bk[w] = torch.where(take, q * P + mine[j], bk[w])
                hit[w] |= ok[..., mine].any(dim=-1)
        if any_hit:
            h = hit.any(dim=0)
            occ[pk] |= h
            closest[pk] = torch.where(h, cmr.RETIRED, closest[pk])
        else:
            t_win = bt.min(dim=0).values
            key = torch.where(bt == t_win, bk, NO_KEY).min(dim=0).values
            won = key < NO_KEY
            q_win = torch.where(won, key // P, 0)
            slot = qids[pk][torch.arange(m)[:, None], q_win] * P + key % P
            closest[pk] = torch.where(won, t_win, c0)
            best[pk] = torch.where(won, slot, best[pk])
        qcnt[pk] = 0
        if any_hit:
            dead = (closest[pk] < 0.0).all(dim=1)
            idx[pk[dead]] = 0
    return leaf_round


def _walks(o, d, tabs, t_near, t_any, W=None):
    """(nearest, any-hit) outputs of the serial walk, or of the split
    model at W warps."""
    n = o.x.shape[0]
    full = lambda v: torch.full((n,), v, dtype=torch.float32)
    with mock.patch.object(cmr, "_leaf_round",
                           split_leaf_round(W) if W else cmr._leaf_round):
        return (cmr._mr_walk_ref(o, d, full(t_near), tabs, T_MIN, False),
                cmr._mr_walk_ref(o, d, full(t_any), tabs, T_MIN, True))


def _assert_walks_equal(got, want):
    for a, b in zip(got, want):  # (t, tri, occ, counters) each mode
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.fixture(scope="module")
def serial_walks():
    """name: the serial walk's outputs on a case of CASES (nearest at
    FLT_MAX, any-hit at t_max 14), each run once."""
    runs = {}

    def run(name, o, d, tabs):
        if name not in runs:
            runs[name] = _walks(o, d, tabs, FLT_MAX, 14.0)
        return runs[name]
    return run


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_merge_model_equals_serial_walk(jax_runs, serial_walks, name,
                                              W):
    """The split-and-merge model at W warps: t, winners, occlusion and
    the per-packet counters bit-equal to the serial walk; its hit masks
    and occlusion equal to the JAX kernel's (interpret mode)."""
    (jm, tm, o, d), jouts, _, jocc = jax_runs(name)
    tabs = cb.heap_tables(tm)
    got = _walks(tv(o), tv(d), tabs, FLT_MAX, 14.0, W)
    _assert_walks_equal(got, serial_walks(name, tv(o), tv(d), tabs))
    np.testing.assert_array_equal(got[0][1].numpy() >= 0,
                                  np.asarray(jouts[1]) >= 0)
    np.testing.assert_array_equal(got[1][2].numpy(), np.asarray(jocc))


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("name", mr_cases.CASES)
def test_split_merge_model_on_ties(name, W):
    """tests/mr_cases.py: the serial walk takes the earlier-queued leaf's
    slot at an equal t, and the lower of two equal-t slots a warp apart;
    the model at W warps equals it, bit for bit."""
    c = mr_cases.case(name)
    tabs = cb.heap_tables(mr_cases.port_mesh(c, "cpu"))
    o, d = tv(c.o), tv(c.d)
    want = _walks(o, d, tabs, FLT_MAX, FLT_MAX)
    (t, tri, _, cnt), (_, _, occ, acnt) = want
    c.check(t.numpy(), tri.numpy(), occ.numpy(), cnt.numpy(), acnt.numpy())
    _assert_walks_equal(_walks(o, d, tabs, FLT_MAX, FLT_MAX, W), want)


# ---------------------------------------------------------------------------
# the issue-rate floor's SASS counts (experiments/bvh_mr_ab.py mr_sass)
# ---------------------------------------------------------------------------


def _fake_sass(slot_body, node_body, merge_body, slots=2, merge_bar=True):
    """A ``cuobjdump -sass`` dump of the two split-walk kernels in the
    form ``mr_sass`` reads: a node round (its 128-bit row loads, slab
    tests and four votes), a round-start barrier, a slot loop of ``slots``
    slot tests (each ``slot_body`` instructions and a MUFU.RCP, with the
    division's slow path, a CALL that a forward branch skips) inside the
    walk loop, and the merge (two stores, the barrier, ``merge_body``
    loads and selects, the join's BSYNC). Returns (text, the counts
    ``mr_sass`` should find)."""
    out = []
    for arg in (0, 1):
        code, labels = [], {}

        def ins(text, label=None):
            if label:
                labels[label] = len(code)
            code.append(text)

        ins("MOV R1, c[0x0][0x28]")
        ins("LDG.E.128.CONSTANT R4, desc[UR6][R18.64]", "walk")
        for _ in range(node_body - 5):
            ins("FADD R5, R4, -R30")
        for p in ("!P3", "!P2", "P1", "P0"):
            ins(f"VOTE.ANY R4, PT, {p}")
        ins("DEPBAR.LE SB0, 0x0")
        ins("BAR.SYNC.DEFER_BLOCKING R35, 0x100")
        loop = len(code)
        for k in range(slots):
            ins("LDS.128 R12, [R3+0x840]", "head" if k == 0 else None)
            for _ in range(slot_body - 5):
                ins("FMUL R13, R12, R25")
            ins("MUFU.RCP R0, R25")
            ins(f"BSSY B5, {{s{k}}}")
            ins(f"@!P0 BRA {{s{k}}}")
            ins("MOV R4, 0x0")
            ins("CALL.REL.NOINC {sub}")
            ins("BSYNC B5", f"s{k}")
        ins("@P0 BRA {head}")
        span = len(code) - loop
        if merge_bar:
            ins("STS [R12], R52")
            ins("STS [R12+0x400], R53")
            ins("BAR.SYNC.DEFER_BLOCKING R35, 0x100")
            for _ in range(merge_body - 4):
                ins("LDS R3, [R12+0x80]")
            ins("BSYNC B2")
        ins("@P1 BRA {walk}")
        ins("EXIT")
        ins("RET.REL.NODEC R4 0x0", "sub")
        addr = {k: f"0x{16 * v:x}" for k, v in labels.items()}
        out.append(f"\t\tFunction : _ZN_9mr_kernelILi{arg}EEEvPKf")
        out += [f"        /*{16 * a:04x}*/   {c.format(**addr)} ;"
                f"   /* 0x000000000000000 */" for a, c in enumerate(code)]
    return "\n".join(out), ((span - 2 * slots) / slots, node_body,
                            merge_body)


@pytest.mark.parametrize("slot,node,merge", [(66, 80, 83), (65, 75, 25)])
def test_mr_sass_counts_slot_node_and_merge(slot, node, merge):
    """``bvh_mr_ab.mr_sass``, which ``chip_smoke.py``'s issue-rate floor
    reads from the build: a slot test (the slot loop over its MUFU.RCPs,
    the division's slow path left out), a node round's loads, slab tests
    and votes, and the merge from its stores to its join, in the nearest
    and any-hit kernels; and the floor those counts give."""
    from tpu_pathtracer_torch.experiments import bvh_mr_ab as ab
    text, want = _fake_sass(slot, node, merge)
    assert ab.mr_sass(text) == {"nearest": want, "any_hit": want}
    ms, ins = ab.issue_floor(want, 64, 8, torch.tensor([10, 20]),
                             torch.tensor([1, 3]), torch.tensor([4, 6]))
    assert ins == want[0] * 64 * 10 + want[1] * 30 + want[2] * 8 * 4
    assert ms == pytest.approx(ins / ab.ISSUE_RATE * 1e3)


def test_mr_sass_refuses_another_form():
    """A build without the merge barrier (the one-warp form before the
    split) is not counted: ``mr_sass`` raises rather than price it."""
    from tpu_pathtracer_torch.experiments import bvh_mr_ab as ab
    with pytest.raises(ValueError):
        ab.mr_sass(_fake_sass(66, 80, 83, merge_bar=False)[0])
    assert ab.warps_per_packet("constexpr int kWarpsPerPacket = 8;") == 8
    assert ab.warps_per_packet("constexpr int kWarps = 8;") == 1
