"""The leaf-fetch probes of the port (``tpu_pathtracer_torch/experiments``):
K14's cluster visits (``leafmt_probe``) and K15's chain of cluster copies
(``dma_probe``), their plain versions against the JAX probes' TPU kernels
in interpret mode (``experiments/leafmt_probe.py`` ``_kernel`` through
``run``, and ``experiments/dma_probe.py`` ``kern_sync`` / ``kern_db``), on
the probes' own seeded inputs at a few visits or copies.

Tolerances. K14: the TPU kernel returns closest + besti * 1e-30, and in
float32 that term vanishes for any t above ~1e-23, so the port's closest is
held against it at rtol 2e-6 (XLA contracts the Moller-Trumbore
multiply-adds into FMAs, ROADMAP C-2), on the same lanes hit. K15: both
sides add the same float32 values in the same order, so acc is exact.

The kernel's split of a visit (``csrc/leafmt_probe.cu``: kLeafLanes lanes
a ray, a (t, slot) shuffle tree) is held by ``tests/leafmt_cases.py``'s
NumPy model, bit for bit, against the plain version on the probe's inputs
and on the tie cases (equal t at two slots, a later visit's t equal to
closest, zero and NaN rows), at the source's lane count and at 8 and 32;
the JAX kernel is held to the same cases. ``mode_sass`` and ``copy_sass``,
the SASS counters, are held on hand-written listings.

``leafmt_probe.py`` guards its ``main()`` and is imported by its path, its
``run`` called with ``pallas_call`` in interpret mode; ``dma_probe.py``
runs its probe at import, so only its kernel functions are compiled from
the file's source. The CUDA kernels run only on a card:
``tests/test_torch_cuda.py`` holds them bit for bit against these plain
versions.
"""

import ast
import functools
import importlib.util
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer_torch.experiments import dma_probe as dm
from tpu_pathtracer_torch.experiments import leafmt_probe as lm
from tpu_pathtracer_torch.ops import _build
from torch_threads import one_torch_thread  # noqa: F401
import leafmt_cases
from sass_listing import listing

EXP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "experiments")
T_RTOL = 2e-6
VISITS = 3


@pytest.fixture(scope="module")
def jleafmt():
    spec = importlib.util.spec_from_file_location(
        "leafmt_probe", os.path.join(EXP, "leafmt_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["pure", "dma", "db"])
def test_leafmt_matches_jax_kernel(jleafmt, mode):
    blocks, o, d = lm.probe_arrays()
    tile = lambda a: jnp.asarray(a.reshape(8, 128))
    args = [tile(o[0]), tile(o[1]), tile(o[2]), tile(d[0]), tile(d[1]),
            tile(d[2]), jnp.full((8, 128), 3.4e38, jnp.float32),
            jnp.asarray(blocks)]
    with mock.patch.object(pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        t_out = np.asarray(jleafmt.run(*args, visits=VISITS, mode=mode))
    t_out = t_out.reshape(-1)
    closest, best = lm.leafmt_run(*lm.probe_inputs(device="cpu"), VISITS,
                                  mode)
    hit = best.numpy() >= 0
    np.testing.assert_array_equal(t_out < 3.4e38, hit)
    np.testing.assert_allclose(closest.numpy(), t_out, rtol=T_RTOL, atol=0)
    assert 0 < hit.sum() < hit.size
    # the winner's visit: cluster 0 in pure, i % C (i < 3) otherwise
    visits = best.numpy()[hit] // lm.WIDTH
    assert (visits == 0).all() if mode == "pure" else len(set(visits)) > 1


def test_leafmt_modes_share_their_function():
    """pure and cond compute one function, dma, db and db2 another; cond
    at skip >= 1 runs no visit."""
    args = lm.probe_inputs(device="cpu")
    out = {m: lm.leafmt_run(*args, 5, m) for m in lm.MODES}
    for a, b in (("pure", "cond"), ("dma", "db"), ("db", "db2")):
        assert all(torch.equal(x, y) for x, y in zip(out[a], out[b]))
    assert not torch.equal(out["pure"][1], out["dma"][1])
    closest, best = lm.leafmt_run(*args, 5, "cond", skip=1)
    assert (best == -1).all() and torch.equal(closest, args[2])


def test_leafmt_plain_version_is_sequential():
    """The chunked plain version against the kernel's loop written out,
    visit by visit and slot by slot, on two tiles; ``_CHUNK`` below one
    visit's ray-slot pairs makes every pass one visit, so the passes'
    strict-less merge is exercised."""
    origin, direction, tmax, clusters = lm.probe_inputs(2, device="cpu")
    with mock.patch.object(lm, "_CHUNK", 1000):
        closest, best = lm.leafmt_run(origin, direction, tmax, clusters, 4,
                                      "dma")
    o, d = origin.stack(), direction.stack()
    c = tmax.clone()
    b = torch.full_like(best, -1)
    inf = torch.full_like(c, float("inf"))
    for i in range(4):
        t, ok = lm.cb.mt_rows(clusters[i % len(clusters)][None], o, d,
                              lm.T_MIN, inf)
        for w in range(lm.WIDTH):
            take = ok[:, w] & (t[:, w] < c)
            c = torch.where(take, t[:, w], c)
            b = torch.where(take, i * lm.WIDTH + w, b)
    assert torch.equal(closest, c) and torch.equal(best, b)
    assert torch.equal(closest[:lm.TILE], closest[lm.TILE:])


def test_clusters_from_blocks_round_trips():
    """The rows hold every live word of the blocks, and nothing else: the
    blocks written back from them are the blocks."""
    blocks, _, _ = lm.probe_arrays(C=7)
    cl = lm.clusters_from_blocks(blocks)
    assert cl.shape == (7, 64, 12) and cl.is_contiguous()
    back = torch.zeros((7, 16, 128))
    back[:, :12, :64] = cl.transpose(1, 2)
    assert torch.equal(back, torch.from_numpy(blocks))
    # a row is (v0, e1, e2, n = e1 x e2), tris.cu's layout
    row = cl[3, 5].numpy()
    np.testing.assert_allclose(row[9:], np.cross(row[3:6], row[6:9]),
                               rtol=1e-6)


def _jax_dma(mode, blocks, k):
    """``dma_probe.py``'s kernels, compiled alone (the file runs its
    probe at import), in interpret mode with the specs of its ``run``
    (:79-85)."""
    C = blocks.shape[0]
    path = os.path.join(EXP, "dma_probe.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("_out", "kern_sync", "kern_db")]
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, C=C, R=8, L=128)
    exec(compile(ast.Module(body, []), path, "exec"), ns)
    kern = ns["kern_sync" if mode == "sync" else "kern_db"]
    out = pl.pallas_call(
        functools.partial(kern, k=k),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)],
        out_specs=pl.BlockSpec((8, 128), lambda: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(jnp.asarray(blocks.numpy().reshape(C, 8, 128)))
    return np.asarray(out)


@pytest.mark.parametrize("mode", dm.MODES)
def test_dma_chain_matches_jax_kernel(mode):
    """k even, as the probe's own are: ``kern_db`` copies in pairs, so at
    an odd k it would drop the last copy."""
    blocks = dm.probe_blocks(16, device="cpu")
    for k in (2, 6, 8):
        out = _jax_dma(mode, blocks, k)
        acc = dm.dma_chain(blocks, k, mode)
        assert acc.shape == () and acc.dtype == torch.float32
        assert (out == out[0, 0]).all() and out[0, 0] == acc.item()
    assert dm.dma_chain(blocks, 0, mode).item() == 0.0
    with pytest.raises(ValueError, match="mode"):
        dm.dma_chain(blocks, 2, "async")


CASES = ["probe", *leafmt_cases.CASES]
SOURCE_LANES = lm.source_form(
    (_build.CSRC_DIR / "leafmt_probe.cu").read_text())[0]


def _case(name):
    """(blocks (C, 16, 128), o [3, 1024], d [3, 1024], t_max [1024])."""
    if name == "probe":
        blocks, o, d = lm.probe_arrays()
        return blocks, o, d, np.full(lm.TILE, 3.4e38, np.float32)
    return leafmt_cases.case(name)


def _port(blocks, o, d, tmax):
    v = lambda a: lm.V3(*(torch.from_numpy(np.ascontiguousarray(c))
                          for c in a))
    return (v(o), v(d), torch.from_numpy(tmax),
            lm.clusters_from_blocks(blocks))


def test_lane_counts_are_the_sources():
    assert SOURCE_LANES == lm.LEAF_LANES == 16
    assert lm.source_form("constexpr int kTile = 1024;") is None


@pytest.mark.parametrize("lanes", sorted({SOURCE_LANES, 8, 32}))
@pytest.mark.parametrize("name", CASES)
def test_split_model_matches_plain_version(name, lanes):
    """The kernel's split of a visit (``lanes`` lanes a ray, the (t, slot)
    shuffle tree) is the plain version's first strict minimum, bit for
    bit, in both functions (every visit to cluster 0; visit i to cluster
    i % C) at 3 visits, and cond's skip = 1 runs no visit."""
    blocks, o, d, tmax = _case(name)
    args = _port(blocks, o, d, tmax)
    clusters = args[3].numpy()
    for mode in ("pure", "dma"):
        want = lm.leafmt_run(*args, 3, mode)
        got = leafmt_cases.split_model(o.T, d.T, tmax, clusters, 3,
                                       mode == "pure", lanes)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
        assert (want[1] >= 0).any()
    got = leafmt_cases.split_model(o.T, d.T, tmax, clusters, 3, True, lanes,
                                   skip=1)
    assert (got[1] == -1).all() and np.array_equal(got[0], tmax)


def test_cases_hold_their_ties():
    """The cases hold what they are for: equal t at two hit slots, the
    lower slot the winner (ties); no winner at a zero or NaN row and none
    on a dead lane (zero_nan); a later visit's equal t keeps the first
    visit's slot (repeat, every mode at 4 visits)."""
    blocks, o, d, tmax = leafmt_cases.case("ties")
    args = _port(blocks, o, d, tmax)
    best = lm.leafmt_run(*args, 1, "pure")[1].numpy()
    t, ok = leafmt_cases.mt_slots(args[3][0].numpy(), o.T, d.T)
    for dup, src in leafmt_cases.DUPLICATES.items():
        tie = ok[:, src] & ok[:, dup] & (t[:, src] == t[:, dup])
        assert (tie & (best == src)).sum() > 10
        assert not (best == dup).any()
    blocks, o, d, tmax = leafmt_cases.case("zero_nan")
    args = _port(blocks, o, d, tmax)
    closest, best = (a.numpy() for a in lm.leafmt_run(*args, 2, "dma"))
    slots = set((best[best >= 0] % lm.WIDTH).tolist())
    assert slots and not slots & {*leafmt_cases.ZERO, *leafmt_cases.NAN,
                                  leafmt_cases.NAN_NORMAL}
    assert (best[tmax <= 0] == -1).all() and (closest <= tmax).all()
    blocks, o, d, tmax = leafmt_cases.case("repeat")
    args = _port(blocks, o, d, tmax)
    for mode in lm.MODES:
        best = lm.leafmt_run(*args, 4, mode)[1].numpy()
        assert (best >= 0).sum() > lm.TILE // 2 and (best < lm.WIDTH).all()


@pytest.mark.parametrize("name", leafmt_cases.CASES)
def test_leafmt_cases_match_jax_kernel(jleafmt, name):
    """The tie cases through the TPU kernel in interpret mode (dma mode, 2
    visits: clusters 0 and 1): the same lanes hit, closest within
    T_RTOL (the TPU kernel's t_out is closest + besti * 1e-30)."""
    blocks, o, d, tmax = leafmt_cases.case(name)
    tile = lambda a: jnp.asarray(a.reshape(8, 128))
    args = [*(tile(c) for c in o), *(tile(c) for c in d), tile(tmax),
            jnp.asarray(blocks)]
    with mock.patch.object(pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        t_out = np.asarray(jleafmt.run(*args, visits=2, mode="dma"))
    t_out = t_out.reshape(-1)
    closest, best = lm.leafmt_run(*_port(blocks, o, d, tmax), 2, "dma")
    hit = best.numpy() >= 0
    np.testing.assert_array_equal(t_out < tmax, hit)
    np.testing.assert_allclose(closest.numpy()[hit], t_out[hit],
                               rtol=T_RTOL, atol=0)
    np.testing.assert_array_equal(closest.numpy()[~hit], tmax[~hit])
    assert hit.sum() > lm.TILE // 8


def _slot_loop(load):
    return (["slot:"] + [f"{load} R4, [R17]"] * 3
            + ["FMUL R0, R22, R5", "MUFU.RCP R0, R43", "@!P0 BRA {fast}",
               "MOV R2, 0xd40", "CALL.REL.NOINC {div}", "fast:"]
            + ["FADD R9, R24, -R9"] * 10
            + ["ISETP.GE.U32.AND P1, PT, R16, 0x40, PT", "@!P1 BRA {slot}"])


def _leafmt_listing(mode, load="LDS.128", bfly=8, copy=True):
    """A leafmt kernel of the split's shape: the visit loop (its copy and
    wait in db) holds the pass loop (7 broadcasts, ``bfly`` SHFL.BFLY and
    the owner's take), which holds the slot loop; after the EXIT, a
    divergent shuffle's stub branches back into the pass and the wait's
    retries back into the visit, closing no loop of the body."""
    visit = ["visit:", "VIADD R30, R31, 0x1", "YIELD"]
    if mode == 3:
        visit += (["MEMBAR.ALL.CTA", "FENCE.VIEW.ASYNC.S",
                   "SYNCS.ARRIVE.TRANS64 RZ, [R6+URZ], R9", "copy:",
                   "@P0 ELECT P1, URZ, PT",
                   "UBLKCP.S.G [UR10], [UR6], UR4" if copy else "NOP",
                   "@P0 BRA.U.ANY {copy}",
                   "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R5+URZ], R2",
                   "@!P0 BRA {retry}", "waited:"])
    body = (visit + ["pass:", "BRA.DIV UR4, {stub}"]
            + ["SHFL.IDX PT, R25, R40, R3, 0x1f"] * 7 + ["back:"]
            + _slot_loop(load) + ["SHFL.BFLY PT, R3, R18, 0x1, 0x1f"] * bfly
            + ["SHFL.IDX PT, R5, R0, R3, 0x1f", "@!P0 BRA {pass}",
               "ISETP.GE.AND P0, PT, R30, UR4, PT", "@!P0 BRA {visit}"])
    retry = (["retry:", "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R5], R2",
              "@!P0 BRA {retry}", "BRA {waited}"] if mode == 3 else [])
    return listing(f"_ZN4anon13leafmt_kernelILi{mode}EEEvPKf",
                   ["LDC R1, c[0x0][0x28]"] * 2 + body
                   + ["STG.E desc[UR8][R2.64], R34", "EXIT"] + retry
                   + ["stub:", "SHFL.IDX P0, R18, R7, R3, R0", "BRA {back}",
                      "div:", "RET.REL.NODEC R2 0x0"])


def test_mode_sass_counts_a_slot_a_pass_and_a_visit():
    """``mode_sass`` on listings of the kernel's shape: a slot test 20 - 2
    (the division's slow path) = 18; a pass 7 + 8 + 3 = 18 beside it; a
    visit 4, db's 12 with its copy and wait; the stubs after the EXIT
    close no loop. ``issue_floor``: 64 slot tests, 16 passes and a visit
    a warp's visit."""
    text = (_leafmt_listing(0) + _leafmt_listing(2, "LDG.E.128.CONSTANT")
            + _leafmt_listing(3))
    sass = lm.mode_sass(text)
    assert sass == {"pure": (18.0, 18, 4), "dma": (18.0, 18, 4),
                    "db": (18.0, 18, 12)}
    ms, ins = lm.issue_floor(sass["db"], 2048, 3)
    assert ins == 2048 // 32 * 3 * (64 * 18 + 16 * 18 + 12)
    assert ms == pytest.approx(ins / lm.ISSUE_RATE * 1e3)
    assert lm.mode_sass(_leafmt_listing(3, bfly=6), lanes=8) == {
        "db": (18.0, 16, 12)}


@pytest.mark.parametrize("what", ["bfly", "load", "copy", "bulk0"])
def test_mode_sass_refuses_another_form(what):
    """Not the 16-lane merge (6 SHFL.BFLY a pass), rows read other than as
    3 LDS.128 a test, db without its bulk copy, or a listing with the
    bulk copy read as the lanes' cp.async form: ``mode_sass`` raises."""
    text = {"bfly": _leafmt_listing(0, bfly=6),
            "load": _leafmt_listing(0, load="LDS.64"),
            "copy": _leafmt_listing(3, copy=False),
            "bulk0": _leafmt_listing(3)}[what]
    with pytest.raises(ValueError):
        lm.mode_sass(text, bulk=what != "bulk0")


def _dma_listing(name, copy=True, wait=True):
    """A dma_probe kernel: lanes 1-31 exit first; the chain loop holds the
    fence, the arrive, the bulk copy's ELECT loop, the wait and the add;
    the wait's retries sit after the last EXIT."""
    chain = (["chain:", "MEMBAR.ALL.CTA", "FENCE.VIEW.ASYNC.S",
              "SYNCS.ARRIVE.TRANS64 RZ, [R3+UR11], R2", "copy:",
              "@P0 ELECT P3, URZ, PT",
              "UBLKCP.S.G [UR12], [UR6], UR5" if copy else "NOP",
              "@P0 BRA.U.ANY {copy}",
              "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R3+UR11], R2" if wait
              else "NOP", "@!P0 BRA {retry}", "waited:",
              "LDS R3, [R3+UR10]", "FADD R0, R3, R0", "@!P2 BRA {chain}"])
    return listing(f"_ZN4anon{name}EPK6float4iiPf",
                   ["S2R R0, SR_TID.X", "@P0 EXIT"] + chain
                   + ["STG.E desc[UR4][R2.64], R0", "EXIT", "retry:",
                      "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R3+UR11], R2",
                      "@!P0 BRA {retry}", "BRA {waited}"])


def test_copy_sass_counts_the_chain_loop():
    """``copy_sass``: the chain loop's 11 instructions, its one bulk copy
    and one wait, in each kernel; ``issue_floor`` at one a cycle; a
    kernel without the bulk copy or the wait raises."""
    text = _dma_listing("11sync_kernel") + _dma_listing("9db_kernel")
    assert dm.copy_sass(text) == {"sync": (11, 1, 1), "db": (11, 1, 1)}
    assert dm.issue_floor(11, 1000) == pytest.approx(
        11 * 1000 / dm.WARP_ISSUE_RATE * 1e3)
    for kw in ({"copy": False}, {"wait": False}):
        with pytest.raises(ValueError):
            dm.copy_sass(_dma_listing("9db_kernel", **kw))
