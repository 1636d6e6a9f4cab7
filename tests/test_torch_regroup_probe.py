"""The regrouped leaf phase of the port
(``tpu_pathtracer_torch/experiments/regroup_probe.py``, K21): its plain
version against the TPU kernel of ``experiments/regroup_probe.py``
(``_kernel`` through ``run_window``) in interpret mode at ``upto`` = mt and
full, against that file's own ``numpy_ref``, and against numpy
restatements of the kernel's ``ct``, ``g``, ``ray`` and ``tri`` blocks
(:134-180; the JAX runs of those four take ~30 s of interpret mode
together, so they are restated here instead), on the TPU file's seeded
inputs (``default_rng(7)``: 807 pairs, no empty visit), on a crafted
window with empty visits and on the cases of ``tests/regroup_cases.py``;
and the kernel's SASS counter (``mode_sass``, ``issue_floor``) on
listings written out by hand (``sass_listing.py``).

The TPU file guards its ``main()`` and is imported by its path. Its
``_kernel`` runs at mt and at full in one interpret-mode ``pallas_call``
with ``run_window``'s specs, jitted: one trace and compile (~20 s) for
the seeded window and the crafted windows of ``tests/regroup_cases.py``
(ties across visits and triangles, a ray only in visit 63, an empty visit
between two, a ray in every visit, t equal to cl0), each ~0.1 s after it.

Tolerances. The split-bf16 fetches are exact, so the slots' rays and
clusters are the float32 inputs on both sides. XLA contracts the
Moller-Trumbore multiply-adds into FMAs (ROADMAP C-2): on the seeded
inputs JAX's t lies up to 6.0e-6 relative from the port's and from the
file's own ``numpy_ref`` (whose ``< 1e-6`` assert the JAX run itself
misses; t cancels near t_min), so t is held at rtol 1e-5 against JAX, with
the hit set and besti exact; against ``numpy_ref`` (no FMA) at the file's
1e-6. The restated blocks are exact. The CUDA kernel runs only on a card:
``tests/test_torch_cuda.py`` holds it bit for bit against this plain
version.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer_torch.experiments import common
from tpu_pathtracer_torch.experiments import regroup_probe as rp
import regroup_cases
from sass_listing import listing
from torch_threads import one_torch_thread  # noqa: F401

EXP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "experiments")
T_RTOL_JAX = 1e-5
T_RTOL_NUMPY = 1e-6


@pytest.fixture(scope="module")
def jrg():
    spec = importlib.util.spec_from_file_location(
        "regroup_probe", os.path.join(EXP, "regroup_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def seeded(jrg):
    """(the TPU file's make_inputs, the port's probe_inputs), both from
    default_rng(7)."""
    return jrg.make_inputs(np.random.default_rng(7)), rp.probe_inputs("cpu")


def _plain(inp, upto):
    return [a.numpy() for a in rp._regroup_ref(
        inp["rays"], inp["masks"], inp["tri"], inp["vpref"], inp["cids"],
        upto)]


def test_inputs_and_split_are_the_tpu_files(seeded):
    j, inp = seeded
    o1, o2, o3, d1, d2, d3, cl0, m, tri_stack, vpref, cids, tri = j
    np.testing.assert_array_equal(
        inp["rays"].numpy(), np.stack([o1, o2, o3, d1, d2, d3, cl0]))
    for got, want in ((inp["masks"], m), (inp["tri"], tri),
                      (inp["vpref"], vpref), (inp["cids"], cids)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(vpref[-1]) == 807 and (np.diff(vpref) > 0).all()
    hi, mid, lo = rp.bf16_split(inp["tri"])
    np.testing.assert_array_equal(
        torch.cat([hi, mid, lo]).view(torch.int16).numpy(),
        np.asarray(tri_stack).view(np.int16))
    # the split reconstructs the clusters and the rays exactly, so the
    # port's float32 reads are the TPU's fetched values
    for x in (inp["tri"], inp["rays"]):
        h, md, lw = rp.bf16_split(x)
        assert torch.equal((h.float() + md.float()) + lw.float(), x)


@pytest.fixture(scope="module")
def jax_kernel(jrg):
    """The TPU kernel at mt and full in one jitted interpret-mode
    ``pallas_call``: (t mt, i mt, t full, i full) of a window's 11 TPU
    operands."""
    def both(*refs):
        for k, upto in enumerate(("mt", "full")):
            jrg._kernel(*refs[:11], *refs[11 + 2 * k:13 + 2 * k], upto=upto,
                        interpret=True)

    spec8 = pl.BlockSpec(memory_space=pltpu.VMEM)
    shapes = (jax.ShapeDtypeStruct((8, 128), jnp.float32),
              jax.ShapeDtypeStruct((8, 128), jnp.int32))
    return jax.jit(pl.pallas_call(
        both, in_specs=[spec8] * 9 + [pl.BlockSpec(
            memory_space=pltpu.SMEM)] * 2,
        out_specs=(spec8,) * 4, out_shape=shapes * 2, interpret=True))


def _run_jax(jax_kernel, args):
    out = [np.asarray(a) for a in jax_kernel(*map(jnp.asarray, args))]
    return {"mt": out[:2], "full": out[2:]}


@pytest.fixture(scope="module")
def jax_out(jax_kernel, seeded):
    """{upto: (t_out, i_out)} of the TPU kernel at mt and full."""
    return _run_jax(jax_kernel, seeded[0][:11])


def _against_jax(inp, out, upto, vpref, cids):
    """The plain version of ``inp`` at ``upto`` against the TPU kernel's
    ``out``: winners exact, the misses the same, t within T_RTOL_JAX."""
    tj, ij = out[upto]
    tp, ip = _plain(inp, upto)
    np.testing.assert_array_equal(ip, ij)
    if upto == "mt":  # per slot: FLT_MAX where nothing was accepted
        miss = tj == np.float32(rp.FLT_MAX)
        np.testing.assert_array_equal(tp == np.float32(rp.FLT_MAX), miss)
        used = np.arange(rp.S).reshape(8, 128) < int(vpref[-1])
        assert miss[~used].all()
        assert (ip[~used] == int(cids[-1]) * rp.W).all()
    else:
        miss = ij < 0
        assert 0 < miss.sum() < miss.size
    np.testing.assert_allclose(tp[~miss], tj[~miss], rtol=T_RTOL_JAX, atol=0)
    return tp, ip


@pytest.mark.parametrize("upto", ["mt", "full"])
def test_matches_jax_kernel(seeded, jax_out, upto):
    j, inp = seeded
    _against_jax(inp, jax_out, upto, j[9], j[10])


def _numpy_ref(jrg, inp):
    rays = inp["rays"].numpy()
    return jrg.numpy_ref(*rays[:7], inp["masks"].numpy(), inp["tri"].numpy(),
                         inp["vpref"].numpy(), inp["cids"].numpy())


def _check_full(jrg, inp):
    t_ref, i_ref = _numpy_ref(jrg, inp)
    tp, ip = _plain(inp, "full")
    np.testing.assert_array_equal(ip, i_ref)
    np.testing.assert_allclose(tp, t_ref, rtol=T_RTOL_NUMPY, atol=0)
    return ip


def test_full_matches_the_files_numpy_ref(jrg, seeded):
    ip = _check_full(jrg, seeded[1])
    assert 0 < (ip >= 0).sum() < ip.size


# ------------------------------------------- restatements of :134-180
def _slots(vpref, cids):
    """Per slot (v, k, cid, used), as the kernel's SMEM loop sets them."""
    out = []
    for s in range(rp.S):
        v = 0
        for vv in range(rp.K):
            if s >= vpref[vv]:
                v = vv
        out.append((v, s - vpref[v], int(cids[v]), s < vpref[rp.K]))
    return out


def _owner(m, v, k):
    """The ray of exclusive rank k among visit v's demanding rays."""
    rays = np.nonzero(m[v].reshape(-1) > 0.5)[0]
    return int(rays[k]) if k < len(rays) else -1


def _restated(inp, upto):
    rays = inp["rays"].numpy().reshape(7, -1)
    m, tri = inp["masks"].numpy(), inp["tri"].numpy()
    slots = _slots(inp["vpref"].tolist(), inp["cids"].tolist())
    t = np.zeros(rp.S, np.float32)
    i = np.zeros(rp.S, np.int32)
    for s, (v, k, cid, used) in enumerate(slots):
        r = _owner(m, v, k) if used else -1
        if upto == "ct":
            t[s] = np.float32(cid) + np.float32(k)
            i[s] = v if used else -1
        elif upto == "g":
            if r >= 0:
                t[r] += 1
            i[s] = int(used)
        elif upto == "ray":
            x = rays[:, r] if r >= 0 else np.zeros(7, np.float32)
            t[s] = ((x[0] + x[1]) + x[2]) + x[6]
            i[s] = int((x[3] + x[4]) + x[5])
        elif used:  # tri
            acc = np.float32(0)
            for w in range(8):
                acc = np.float32(acc + tri[v, w] * np.float32(0.5))
            t[s] = acc
    return t.reshape(8, 128), i.reshape(8, 128)


@pytest.mark.parametrize("upto", ["ct", "g", "ray", "tri"])
def test_early_stages_match_their_restatement(seeded, upto):
    inp = seeded[1]
    tp, ip = _plain(inp, upto)
    tr, ir = _restated(inp, upto)
    np.testing.assert_array_equal(tp, tr)
    np.testing.assert_array_equal(ip, ir)


@pytest.fixture(scope="module")
def crafted():
    """The seeded window with visits 5 and 6 emptied, so 5, 6 and 7 share
    a vpref and visit 7 takes their slots."""
    inp = rp.probe_inputs("cpu")
    inp["masks"][5:7] = 0.0
    counts = (inp["masks"].reshape(rp.K, -1) > 0.5).sum(1)
    vpref = torch.zeros(rp.K + 1, dtype=torch.int32)
    vpref[1:] = torch.cumsum(counts, 0).to(torch.int32)
    inp["vpref"] = vpref
    assert vpref[5] == vpref[6] == vpref[7] < vpref[8]
    return inp


def test_crafted_empty_visits(jrg, crafted):
    """The later of visits sharing a vpref wins their slots (ct), every
    pair keeps its slot (g), and full still matches ``numpy_ref``."""
    vp = crafted["vpref"].tolist()
    _, ip = _plain(crafted, "ct")
    assert (ip.reshape(-1)[vp[5]:vp[8]] == 7).all()
    assert (ip.reshape(-1)[vp[rp.K]:] == -1).all()
    tg, ig = _plain(crafted, "g")
    assert tg.sum() == vp[rp.K] == ig.sum()
    for upto in ("ct", "g", "ray", "tri"):
        for a, b in zip(_plain(crafted, upto), _restated(crafted, upto)):
            np.testing.assert_array_equal(a, b)
    _check_full(jrg, crafted)


def test_unused_slots_miss_on_visit_63(seeded):
    """Slots at or past vpref[64] take visit 63 and no ray: FLT_MAX and
    cids[63] * 64, as the TPU kernel's one-hot gives them."""
    inp = seeded[1]
    tp, ip = _plain(inp, "mt")
    end = int(inp["vpref"][rp.K])
    assert (tp.reshape(-1)[end:] == np.float32(rp.FLT_MAX)).all()
    assert (ip.reshape(-1)[end:] == int(inp["cids"][rp.K - 1]) * rp.W).all()


def test_windows_and_blocks_repeat_one_window(seeded):
    inp = seeded[1]
    t1, i1 = rp.regroup_window(inp, "full")
    t3, i3 = rp.regroup_window(inp, "full", windows=2, blocks=3)
    assert t1.shape == (1, 8, 128) and t3.shape == (3, 8, 128)
    assert torch.equal(t3, t1.repeat(3, 1, 1))
    assert torch.equal(i3, i1.repeat(3, 1, 1))


def test_scalars_refused(seeded):
    """The kernel's scalar operands: host int32, vpref from 0, never
    decreasing, at most S pairs."""
    inp = seeded[1]
    rp._scalars(inp["vpref"], inp["cids"])
    bad = inp["vpref"].clone()
    bad[-1] = rp.S + 1
    with pytest.raises(ValueError, match="exceed"):
        rp._scalars(bad, inp["cids"])
    bad = inp["vpref"].clone()
    bad[3] = bad[4] + 1
    with pytest.raises(ValueError, match="never decrease"):
        rp._scalars(bad, inp["cids"])
    with pytest.raises(TypeError):
        rp._scalars(inp["vpref"].long(), inp["cids"])
    with pytest.raises(ValueError, match="upto"):
        rp.regroup_window(inp, "bogus")


# ------------------------------------------ the crafted windows' cases
def _jax_args(jrg, rays, masks, vpref, cids, tri):
    """A case's 11 TPU operands: the rays' 7 tiles, the masks, the
    clusters' 3-term bf16 split stacked as ``make_inputs`` stacks it, and
    the scalars."""
    hi, mid, lo = jrg.split3(jnp.asarray(tri))
    return (*rays, masks, jnp.concatenate([hi, mid, lo], axis=0), vpref,
            cids)


@pytest.mark.parametrize("upto", ["mt", "full"])
@pytest.mark.parametrize("name", regroup_cases.CASES)
def test_cases_match_jax_kernel(jrg, jax_kernel, name, upto):
    """Each crafted window through the TPU kernel in interpret mode: the
    plain version's winners exact, t within T_RTOL_JAX, and each crafted
    ray's (t, winner) the case's to the bit on both sides."""
    arrays = regroup_cases.case(name)
    rays, masks, vpref, cids, tri = arrays
    out = _run_jax(jax_kernel, _jax_args(jrg, *arrays))
    tp, ip = _against_jax(regroup_cases.inputs(name, "cpu"), out, upto,
                          vpref, cids)
    if upto == "full":
        for r, (t, i) in regroup_cases.EXPECT[name].items():
            for tt, ii in ((tp, ip), out["full"]):
                assert (tt.reshape(-1)[r], ii.reshape(-1)[r]) == (
                    np.float32(t), i), (name, r)


@pytest.mark.parametrize("name", regroup_cases.CASES)
def test_cases_match_the_files_numpy_ref(jrg, name):
    """Each crafted window against the TPU file's ``numpy_ref`` (slot
    order is visit order, the earlier visit winning a tie), and the cases'
    own shapes: visit 20 empty between 19 and 21, every visit demanded."""
    inp = regroup_cases.inputs(name, "cpu")
    ip = _check_full(jrg, inp)
    assert 0 < (ip >= 0).sum() < ip.size
    vp = inp["vpref"].tolist()
    if name == "empty_between":
        assert vp[19] < vp[20] == vp[21] < vp[22]
    if name == "every_visit":
        assert (inp["masks"].reshape(rp.K, -1)[:, 777] > 0.5).all()
    tg, _ = _plain(inp, "g")
    for r in regroup_cases.EXPECT[name]:
        demanded = int((inp["masks"].reshape(rp.K, -1)[:, r] > 0.5).sum())
        assert tg.reshape(-1)[r] == demanded


# ------------------------------------------------ the SASS counter
FULL = "_ZN12_GLOBAL__N_114regroup_kernelILi5EEEvPKfS2_S2_NS_7ScalarsEiPfPi"


def _window(steps, copy=True, atom=False):
    """A hand-written window loop: the ranking loop (4 instructions, 2
    ballots), then ``steps`` (the step loop's lines), a store, the
    window's branch back and the EXIT."""
    return (["MOV R1, c[0x0][0x28]", "win:", "S2R R0, SR_TID.X"]
            + (["UBLKCP.S.G [UR4], [UR6], UR8"] if copy else [])
            + (["ATOMS.MIN.64 RZ, [R2], R4"] if atom else [])
            + ["rank:", "LDG.E R2, desc[UR4][R4.64]", "VOTE.ANY R5, PT, P0",
               "VOTE.ANY R6, PT, P1", "@P2 BRA {rank}",
               "BAR.SYNC.DEFER_BLOCKING 0x0"]
            + steps + ["STS [R21], R22", "@P5 BRA {win}", "EXIT",
                       "end:", "BRA {end}"])


STEP = ["step:", "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R8+URZ], R9",
        "LDS R10, [R11]", "test:", "MUFU.RCP R12, R13", "FMUL R14, R12, R15",
        "MUFU.RCP R16, R17", "FADD R18, R14, R16", "@P3 BRA {test}",
        "SHFL.BFLY PT, R19, R20, 0x1, 0x1f", "@P4 BRA {step}"]


def test_mode_sass_counts_a_window():
    """(test, step, rank, rest): the test loop over its MUFU.RCPs (5 / 2),
    the step loop less it (9 - 5), the ranking loop over its ballots
    (4 / 2), the window loop less both (18 - 4 - 9); a step whose tests
    are unrolled into it counts them all as tests (8 / 2)."""
    sass = rp.mode_sass(listing(FULL, _window(STEP)))
    assert sass == {"full": (2.5, 4, 2.0, 5)}
    flat = [ln for ln in STEP if ln not in ("test:", "@P3 BRA {test}")]
    assert rp.mode_sass(listing(FULL, _window(flat))) == {
        "full": (4.0, 0, 2.0, 5)}
    floor = rp.issue_floor((2.5, 4, 2.0, 5), pairs=8, windows=2, lanes=4,
                           rate=1e6)
    # 2 windows of 32 warps x (64 x 2 + 5) and 1 step x (4 + 16 x 2.5)
    assert floor == pytest.approx(2 * (32 * 133 + 44) / 1e6 * 1e3)


def test_mode_sass_refuses_other_forms():
    """A shared-memory atomic (the first form's merge) raises, and so
    does a staged mode without the bulk copy; the package's source is in
    the staged form at 4 lanes a slot, the first form in none."""
    with pytest.raises(ValueError, match="atomics"):
        rp.mode_sass(listing(FULL, _window(STEP, atom=True)))
    with pytest.raises(ValueError, match="UBLKCP"):
        rp.mode_sass(listing(FULL, _window(STEP, copy=False)))
    assert rp.source_lanes(rp._build.CSRC_DIR.joinpath(
        "regroup_probe.cu").read_text()) == 4
    assert rp.source_lanes("constexpr int kS = 1024;") is None


def test_bound_counts_distinct_bytes_once():
    """The bound: every window's FP32 operations, the distinct inputs
    once a launch whatever the windows and blocks, 8 KB of outputs a
    block. Card-wide mt and full are bound by operations, one block's
    few windows by bytes."""
    flops, nbytes = rp.work("full", 807)
    assert flops == 37 * 64 * 807
    assert nbytes == 4 * 64 * 1024 + 4 * 7 * 1024 + 64 * 12 * 64 * 4
    for windows, blocks in ((1, 1), (4, 1), (1028, 1), (1, rp.CARD_BLOCKS)):
        want = common.roofline(flops * windows * blocks,
                               nbytes + rp.OUT_BYTES * blocks)
        assert rp.bound("full", 807, windows, blocks) == want
    assert rp.bound("full", 807, 1, rp.CARD_BLOCKS)[1] == "operations"
    assert rp.bound("mt", 807, 4)[1] == "bytes"
    assert rp.work("ct", 807)[1] == 0
    assert rp.bound("ct", 807, 1028)[0] < rp.bound("ct", 807, 1, 1028)[0]
