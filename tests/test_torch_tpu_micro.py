"""The TPU micro-benchmarks of the port
(``tpu_pathtracer_torch/experiments/tpu_micro.py``): the plain versions of
K17a-K17c, K18, K19 and K20 against the TPU kernels of
``experiments/tpu_micro.py`` run in interpret mode, and E1 and E6 against
its XLA ``run`` functions, on the TPU file's seeded inputs at a few steps;
K18 also on the edge inputs of ``tests/micro_cases.py`` (E5's kernel
rebuilt at their block count), and its SASS counter (``copy_sass``) on a
listing written out by hand.

The TPU file is loaded by its path (its ``main`` is guarded). Each of its
experiments is called once with ``pl.pallas_call`` recording the callable
it builds, in interpret mode, and with ``timed_slope`` recording the
``run`` it would time; the callables then run on the inputs here.

Tolerances. E3, E4, E5 and E7: the same float32 operations in the same
order (E4's vote depends only on the sign of its sum), so bit-equal. E8
and E9: XLA contracts the test's multiply-adds into FMAs (ROADMAP C-2),
and the test's t cancels: on the seeded inputs both sides lie up to ~3e-5
from the float64 value. So t is held, on the lanes both sides hit and
against each other and the float64 value, at the larger of 2e-6 and 4 eps
kappa relative, kappa the winner's condition number (both sides measured
within 1.3 eps kappa of each other); the hit sets are equal except on
lanes with a triangle whose u, v, u + v, t or |a| lies within 2^-20 of an
accept bound, and the chain of clusters is equal. E1 and E6 return
float32 sums that XLA and torch add in other orders: rtol 1e-6; E6's keys
and payloads exact. The CUDA kernels run only on a card:
``tests/test_torch_cuda.py`` holds them bit for bit against these plain
versions.
"""

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

from tpu_pathtracer_torch.experiments import tpu_micro as um
import leaf_cases
import micro_cases
from sass_listing import listing
from torch_threads import one_torch_thread  # noqa: F401

EXP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "experiments")
DELTA = 2.0 ** -20
T_RTOL = 2e-6
STEPS = 3


@pytest.fixture(scope="module")
def jmicro():
    """{experiment: the Pallas callable it builds (interpret mode), or the
    ``run`` functions it would time (E1: one a table, E6)}; "E5 call",
    "E8 call", "E9 call": the arguments the experiment gives
    ``pallas_call`` (its kernel first)."""
    spec = importlib.util.spec_from_file_location(
        "tpu_micro", os.path.join(EXP, "tpu_micro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    built, timed = [], []
    real = pl.pallas_call

    def record(*a, **k):
        built.append(real(*a, interpret=True, **k))
        calls.append((a, k))
        return built[-1]

    out, calls = {}, []
    with mock.patch.object(pl, "pallas_call", record), \
            mock.patch.object(mod, "timed_slope",
                              lambda fn, lo, hi, reps=3: timed.append(fn)
                              or 1.0):
        for name in ("e1", "e3", "e4", "e5", "e6", "e7", "e8", "e9"):
            built.clear()
            timed.clear()
            calls.clear()
            getattr(mod, name)()
            out[name.upper()] = built[0] if built else list(timed)
            if name in ("e5", "e8", "e9"):
                out[f"{name.upper()} call"] = calls[0]
    return out


@pytest.fixture(scope="module")
def inp():
    return um.probe_inputs(device="cpu")


def _steps(n):
    return jnp.asarray([n], jnp.int32)


def _j(t):
    return jnp.asarray(t.numpy())


def test_e3_matches_jax_kernel(jmicro, inp):
    idx = um.lanes_of(inp, "E3", wide=False)
    want = np.asarray(jmicro["E3"](_steps(STEPS), _j(inp["table"]), _j(idx)))
    got = um.gather_chain(inp["table"], idx, STEPS)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_e7_matches_jax_kernel(jmicro, inp):
    idx = um.lanes_of(inp, "E7", wide=False)
    want = np.asarray(jmicro["E7"](_steps(STEPS), _j(inp["table"]), _j(idx)))
    got = um.onehot_chain(inp["table"], idx, STEPS)
    assert got.shape == (8, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    # every step added a bf16 value: the sums are not the f32 gathers'
    assert not torch.equal(got, um._gather_ref(inp["table"],
                                               idx.expand(8, -1), STEPS))


@pytest.mark.parametrize("steps", [STEPS, 17])
def test_e4_matches_jax_kernel(jmicro, inp, steps):
    want = np.asarray(jmicro["E4"](_steps(steps), _j(inp["rows"]),
                                   _j(inp["x"])))
    margins = []
    got = um._row_vote_ref(inp["rows"], inp["x"], steps, margins)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(um.row_vote_chain(inp["rows"], inp["x"], steps), got)
    assert len(margins) == steps and min(m.item() for m in margins) > 1e-4


@pytest.mark.parametrize("steps", [STEPS, 17])
def test_e5_matches_jax_kernel(jmicro, inp, steps):
    want = np.asarray(jmicro["E5"](_steps(steps), _j(inp["blocks"])))
    got = um.copy_chain(inp["blocks"], steps)
    assert got.shape == (1, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def _with_blocks(jmicro, exp, C):
    """``exp``'s TPU kernel (E5, E8 or E9), in interpret mode, with its
    block count C (a constant of the TPU file's experiment) set to ``C``:
    the same code, the closure's C cell replaced."""
    (fn, *rest), kw = jmicro[f"{exp} call"]
    code = fn.__code__
    cells = tuple(types.CellType(C) if name == "C" else cell
                  for name, cell in zip(code.co_freevars, fn.__closure__))
    assert "C" in code.co_freevars
    kernel = types.FunctionType(code, fn.__globals__, fn.__name__,
                                fn.__defaults__, cells)
    return pl.pallas_call(kernel, *rest, interpret=True, **kw)


@pytest.mark.parametrize("name", list(micro_cases.COPY_CASES))
def test_e5_edge_inputs_match_jax_kernel(jmicro, name):
    """K18's plain version on tests/micro_cases.py's edge inputs against
    E5's TPU kernel (at the case's C): int(acc[0]) negative, a multiple of
    3 and saturated (every branch of the floor mod); C = 1; one step."""
    blocks = micro_cases.copy_blocks(name)
    steps = micro_cases.COPY_CASES[name]
    C = blocks.shape[0]
    kern = jmicro["E5"] if C == um.COPY_BLOCKS else _with_blocks(jmicro,
                                                                 "E5", C)
    want = np.asarray(kern(_steps(steps), jnp.asarray(blocks)))
    got = um.copy_chain(torch.from_numpy(blocks), steps)
    assert got.shape == (1, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "negative":
        ints = micro_cases.chain_ints(blocks, steps)
        assert -2 ** 31 in ints
        assert any(i < 0 and i % 3 == 0 for i in ints)
        assert any(i < 0 and -i % 3 for i in ints)


def _exact(blocks, ox, chain):
    """Float64 over the clusters of ``chain``, per lane: the least accepted
    t, the relative condition number kappa of the winner's t (its
    numerator's and a's sums of |terms| over |result|: a float32
    evaluation in any order, with or without FMAs, is within a few eps
    kappa of it), and whether some triangle has its u, v, u + v, t or |a|
    within 2^-20 of an accept bound; and every (triangle, lane)'s kappa."""
    q = torch.cat([blocks[c, :9] for c in chain], dim=1).double()
    o = ox.reshape(1, -1).double()
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = q[:, :, None]
    hx, hy, hz = o * e2z - v0y * e2y, o * e2x - v0z * e2z, o * e2y - v0x * e2x
    sx, sy, sz = o - v0x, o - v0y, o - v0z
    qx, qy, qz = sy * e1z - sz * e1y, sz * e1x - sx * e1z, sx * e1y - sy * e1x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / torch.where(a.abs() < um.EPS_A, torch.ones_like(a), a)
    u = f * (sx * hx + sy * hy + sz * hz)
    v = f * (o * qx + o * qy + o * qz)
    num = e2x * qx + e2y * qy + e2z * qz
    t = f * num
    ok = (u > 0) & (v > 0) & (u + v < 1) & (t > um.T_MIN)
    m = lambda *p: functools.reduce(torch.mul, [z.abs() for z in p])
    H = (m(o, e2z) + m(v0y, e2y), m(o, e2x) + m(v0z, e2z),
         m(o, e2y) + m(v0x, e2x))
    S = [o.abs() + w.abs() for w in (v0x, v0y, v0z)]
    Q = (S[1] * e1z.abs() + S[2] * e1y.abs(), S[2] * e1x.abs() + S[0] *
         e1z.abs(), S[0] * e1y.abs() + S[1] * e1x.abs())
    big_a = sum(m(e, h) for e, h in zip((e1x, e1y, e1z), H))
    big_n = sum(m(e, w) for e, w in zip((e2x, e2y, e2z), Q))
    kappa = big_n / num.abs() + big_a / a.abs()
    ts = torch.where(ok, t, torch.full_like(t, um.FAR))
    best, w = ts.min(0)
    lanes = torch.arange(o.shape[1])
    d = DELTA
    near = ((u.abs() <= d) | (v.abs() <= d) | ((u + v - 1).abs() <= d)
            | ((t - um.T_MIN).abs() <= d * um.T_MIN)
            | ((a.abs() - um.EPS_A).abs() <= d * um.EPS_A)).any(0)
    return best.numpy(), kappa[w, lanes].numpy(), near.numpy(), kappa


def _hold_leaf_to_jax(kern, blocks, x, steps, exp, hits=True, bound=None):
    """The plain version of ``exp`` against its TPU kernel ``kern`` (in
    interpret mode) on ``blocks`` and lanes ``x`` over ``steps`` leaves:
    the same chain of clusters (the TPU kernel's read from its best after
    each step) and best within the stated tolerance; ``hits``: some lanes
    hit and some miss. ``bound``: {lane: triangle (its index along the
    chain's clusters)} whose t is 0.001 exactly in float32, which the
    plain version excludes; XLA's FMAs (ROADMAP C-2) may put that t above
    it and accept it, so on those lanes the TPU kernel's best is either the
    plain version's or within 4 eps kappa of 0.001, kappa that triangle's
    condition number. Returns the plain version's chain."""
    C = blocks.shape[0]
    jb, jx = _j(blocks), _j(x)
    # the TPU kernel's best after each step: its chain of clusters
    jbest = [np.asarray(kern(_steps(s), jb, jx)).reshape(-1)
             for s in range(1, steps + 1)]
    trail = []
    got = um._leaf_ref(blocks, x, steps, um.LEAF_MODES[exp], trail)
    assert torch.equal(um.leaf_chain(blocks, x, steps, exp), got)
    chain = [int(c) for c in trail]
    jchain = [0][:steps]
    for b in jbest[:-1]:
        lane0 = 2 ** 31 - 1 if b[0] >= 2.0 ** 31 else int(b[0])
        jchain.append((jchain[-1] * 5 + lane0 % 3 + 1) % C)
    assert chain == jchain
    got = got.reshape(-1).numpy()
    if not steps:
        want = np.asarray(kern(_steps(0), jb, jx)).reshape(-1)
        assert (got == um.FAR).all() and (want == um.FAR).all()
        return chain
    want = jbest[-1]
    exact, kappa, near, kappas = _exact(blocks, x, chain)
    free = np.zeros(got.shape, bool)
    bound = bound or {}
    free[list(bound)] = True
    for lane, w in bound.items():  # that triangle's kappa sets the room
        room = 4 * 2.0 ** -24 * kappas[w, lane].item() * um.T_MIN
        assert got[lane] > um.T_MIN
        assert (abs(want[lane] - um.T_MIN) <= room
                or abs(got[lane] - want[lane]) <= T_RTOL * got[lane])
    hit_j, hit_p = want < um.FAR, got < um.FAR
    both = hit_j & hit_p & ~free
    rtol = np.maximum(T_RTOL, 4 * 2.0 ** -24 * kappa)[both]
    assert (np.abs(got - want)[both] <= rtol * want[both]).all()
    assert (np.abs(got - exact)[both] <= rtol * exact[both]).all()
    assert (got[~hit_p] == um.FAR).all()
    assert not hits or 0 < both.sum() < both.size
    differ = (hit_j != hit_p) & ~free
    assert differ.sum() <= 8 and not (differ & ~near).any(), \
        f"{differ.sum()} lanes' hits differ, {(differ & ~near).sum()} " \
        "with no triangle near an accept bound"
    return chain


@pytest.mark.parametrize("miss", [False, True])
@pytest.mark.parametrize("exp", ["E8", "E9"])
def test_leaf_matches_jax_kernel(jmicro, inp, exp, miss):
    """``miss``: lane 0's o1 is NaN, so it never hits and the chain runs on
    int(1e30), saturated to 2147483647."""
    blocks, x = inp["blocks"][:um.LEAF_CLUSTERS], inp["x"].clone()
    if miss:
        x[0, 0] = float("nan")
    chain = _hold_leaf_to_jax(jmicro[exp], blocks, x, STEPS, exp)
    assert len(set(chain)) == STEPS
    assert (chain[1] == (2 ** 31 - 1) % 3 + 1) == miss


@pytest.mark.parametrize("name", list(leaf_cases.LEAF_CASES))
@pytest.mark.parametrize("exp", ["E8", "E9"])
def test_leaf_edge_cases_match_jax_kernel(jmicro, exp, name):
    """K19's and K20's plain versions on tests/leaf_cases.py's edge inputs
    against E8's and E9's TPU kernels (at the case's C): a chain on
    2^31 - 1, a tie across lanes of a split, the f = 1 path, t at 0.001
    (lane 29: the plain version excludes it; XLA's FMAs may not, C-2),
    C = 1, 0 and 1 leaves."""
    blocks, x, steps = leaf_cases.leaf_case(name)
    C = blocks.shape[0]
    kern = jmicro[exp] if C == um.LEAF_CLUSTERS else _with_blocks(jmicro,
                                                                 exp, C)
    bound = ({leaf_cases.T_MIN_LANE: leaf_cases.T_MIN_W} if name == "t_min"
             else None)  # cluster 0 leads the chain: its triangles first
    chain = _hold_leaf_to_jax(kern, torch.from_numpy(blocks),
                              torch.from_numpy(x), steps, exp,
                              hits=steps > 0, bound=bound)
    assert len(chain) == steps
    if name == "ray0_misses":
        assert chain == [*leaf_cases.MISS_CHAIN, 312, 537]
    if name == "one_cluster":
        assert chain == [0] * steps


def _lane_test(blocks, x, c, lane, w):
    """(t, accepted, u, v, a) of lane ``lane`` against triangle ``w`` of
    cluster ``c``, in float32 in the plain version's order."""
    o = np.float32(x.reshape(-1)[lane])
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = blocks[c, :9, w]
    hx, hy, hz = o * e2z - v0y * e2y, o * e2x - v0z * e2z, o * e2y - v0x * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = np.float32(1) / (np.float32(1) if abs(a) < um.EPS_A else a)
    sx, sy, sz = o - v0x, o - v0y, o - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx, qy, qz = sy * e1z - sz * e1y, sz * e1x - sx * e1z, sx * e1y - sy * e1x
    v = f * (o * qx + o * qy + o * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = u > 0 and v > 0 and u + v < 1 and t > np.float32(um.T_MIN)
    t_torch, ok_torch = um.mt_ish(torch.tensor([o]),
                                  torch.from_numpy(blocks[c, :9, w:w + 1]))
    assert t_torch.item() == t and ok_torch.item() == ok
    return t, ok, u, v, a


@pytest.mark.parametrize("name", ["ray0_misses", "tie", "flat", "t_min"])
def test_leaf_cases_hold_what_they_say(name):
    """Each edge input holds its edge, in float32 in the plain version's
    order (and by ``mt_ish``)."""
    blocks, x, _ = leaf_cases.leaf_case(name)
    tb, tx = torch.from_numpy(blocks), torch.from_numpy(x)
    if name == "ray0_misses":
        for c in leaf_cases.MISS_CHAIN:
            _, ok = um.mt_ish(tx.reshape(-1)[:1], tb[c, :9])
            assert not ok.any()
        _, ok = um.mt_ish(tx.reshape(-1)[:1], tb[312, :9])
        assert ok.any()
    elif name == "tie":
        t, ok = um.mt_ish(tx.reshape(-1)[:1], tb[0, :9])
        ts = torch.where(ok, t, torch.full_like(t, um.FAR))[:, 0]
        ws = [leaf_cases.TIE_W, *leaf_cases.TIE_COPIES]
        assert (ts[ws] == ts.min()).all() and int((ts == ts.min()).sum()) == 4
        for split in (8, 16, 32):
            assert len({w % split for w in ws}) > 1
    elif name == "flat":
        t, ok, _, _, a = _lane_test(blocks, x, 0, leaf_cases.FLAT_LANE,
                                    leaf_cases.FLAT_W)
        assert ok and abs(a) < um.EPS_A
        ts, oks = um.mt_ish(tx.reshape(-1)[leaf_cases.FLAT_LANE:][:1],
                            tb[0, :9])
        assert torch.where(oks, ts, um.FAR).min().item() == t
    else:
        t, ok, u, v, _ = _lane_test(blocks, x, 0, leaf_cases.T_MIN_LANE,
                                    leaf_cases.T_MIN_W)
        assert t == np.float32(um.T_MIN) and not ok
        assert u > 0 and v > 0 and u + v < 1
        ts, oks = um.mt_ish(tx.reshape(-1)[leaf_cases.T_MIN_LANE:][:1],
                            tb[0, :9])
        assert torch.where(oks, ts, um.FAR).min().item() > t


def test_leaf_plain_versions_equal(inp):
    """E8's triangle-by-triangle update and E9's chunk minima give the
    same best, bit for bit, along the same chain of clusters."""
    blocks = inp["blocks"][:um.LEAF_CLUSTERS]
    t8, t9 = [], []
    b8 = um._leaf_ref(blocks, inp["x"], 6, "smem", t8)
    b9 = um._leaf_ref(blocks, inp["x"], 6, "lanes", t9)
    assert torch.equal(b8, b9)
    assert [int(c) for c in t8] == [int(c) for c in t9]
    assert len({int(c) for c in t8}) == 6


@pytest.mark.parametrize("exp", ["E3", "E7"])
def test_wide_lanes_equal_tpu_shape(inp, exp):
    """At 131,072 lanes the TPU's lanes run as at the TPU shape: lanes are
    independent."""
    fn = um.gather_chain if exp == "E3" else um.onehot_chain
    narrow = fn(inp["table"], um.lanes_of(inp, exp, False), STEPS)
    wide = fn(inp["table"], um.lanes_of(inp, exp, True), STEPS)
    assert wide.shape == (8, um.WIDE_LANES[exp])
    assert torch.equal(wide[:, :narrow.shape[1]], narrow)
    assert not torch.equal(wide[:, narrow.shape[1]:2 * narrow.shape[1]],
                           narrow)


def test_e1_matches_jax_run(jmicro):
    """E1's two tables (never E2's 168 MB one), through the captured
    ``run``; idx never depends on the table (ROADMAP C-17)."""
    for run, w in zip(jmicro["E1"], (16, 1)):
        table, idx = um.gather_inputs(um.T, w, device="cpu")
        acc = um.row_gather(table, idx, STEPS)
        want = float(run(STEPS, 0))
        np.testing.assert_allclose(acc.double().sum().item(), want,
                                   rtol=1e-6)
        # C-17: acc is the table read along the bare LCG, which the
        # gathered values never touch
        lcg, plain = idx, torch.zeros_like(acc)
        for _ in range(STEPS):
            plain = plain + table[lcg, 0]
            lcg = (lcg * um.LCG & 0xFFFFFFFF) % um.T
        assert torch.equal(acc, plain)


def test_e6_matches_jax_run(jmicro):
    keys, pays = um.sort_inputs(device="cpu")
    k, ps = um.sort_chain(keys, pays, 2)
    (run,) = jmicro["E6"]
    want = float(run(2, 0))
    got = k.double().sum().item() + sum(p.double().sum().item() for p in ps)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    jk = jnp.asarray(keys.numpy().astype(np.uint32))
    jp = tuple(_j(p) for p in pays)
    for _ in range(2):
        out = jax.lax.sort((jk,) + jp, num_keys=1)
        jk, jp = out[0] ^ jnp.uint32(12345), out[1:]
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    for p, q in zip(ps, jp):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))


def test_integer_semantics_follow_jax():
    """The wrapped int32 floor mod and the saturating float-to-int against
    JAX on the CPU."""
    v = torch.tensor([0, 5, 16383, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1,
                      16384 * 1664525 + 7], dtype=torch.int64)
    want = np.asarray(jnp.asarray(v.numpy().astype(np.uint32).view(np.int32))
                      % 16384)
    np.testing.assert_array_equal(um._int32_mod(v, 16384).numpy(), want)
    x = torch.tensor([0.0, 2.9, -2.9, 1e30, -1e30, 2.0 ** 31, float("nan")])
    want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.int32))
    np.testing.assert_array_equal(um._f2i(x).numpy(), want)


def test_block_sum_is_the_shuffle_tree():
    """The plain sum adds lane i and lane i + off at off = 16 .. 1 in each
    warp, then the 32 warp partials the same way."""
    rng = np.random.RandomState(3)
    near = torch.from_numpy(rng.randn(8, 128).astype(np.float32))

    def tree(v):
        v = list(v)
        off = 16
        while off:
            v = [np.float32(v[i] + v[i + off]) for i in range(off)]
            off //= 2
        return v[0]

    parts = [tree(near.reshape(-1)[32 * w:32 * w + 32].numpy())
             for w in range(32)]
    assert um.block_sum(near).item() == tree(parts)


def test_wrappers_refuse_bad_arguments(inp):
    with pytest.raises(ValueError, match="mode"):
        um.gather_chain(inp["table"], um.lanes_of(inp, "E3", False), 1,
                        "hbm")
    with pytest.raises(ValueError, match="exp"):
        um.leaf_chain(inp["blocks"], inp["x"], 1, "E5")
    with pytest.raises(ValueError, match="steps"):
        um.copy_chain(inp["blocks"], -1)
    assert torch.equal(um.copy_chain(inp["blocks"], 0),
                       torch.zeros((1, 128)))
    assert (um.leaf_chain(inp["blocks"], inp["x"], 0) == um.FAR).all()


def test_copy_sass_counts_the_chain_loop():
    """K18's chain loop in a hand-written listing: its instructions once,
    its bulk copy and its mbarrier wait; raises without the bulk copy
    (the first form's threads' loads)."""
    name = "_ZN12_GLOBAL__N_111copy_kernelEPK6float4iiPf"
    chain = ["MOV R1, c[0x0][0x28]", "loop:", "UBLKCP.S.G [UR4], [UR6], UR8",
             "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R8+URZ], R9",
             "LDS.128 R4, [R10]", "FADD R12, R12, R4",
             "SHFL.IDX PT, R13, R14, RZ, 0x1f", "@P1 BRA {loop}", "EXIT",
             "end:", "BRA {end}"]
    assert um.copy_sass(listing(name, chain)) == (6, 1, 1)
    with pytest.raises(ValueError, match="bulk copy"):
        um.copy_sass(listing(name, [ln for ln in chain
                                    if not ln.startswith("UBLKCP")]))
