"""The TPU micro-benchmarks of the port
(``tpu_pathtracer_torch/experiments/tpu_micro.py``): the plain versions of
K17a-K17c, K18, K19 and K20 against the TPU kernels of
``experiments/tpu_micro.py`` run in interpret mode, and E1 and E6 against
its XLA ``run`` functions, on the TPU file's seeded inputs at a few steps.

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
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_pathtracer_torch.experiments import tpu_micro as um
from torch_threads import one_torch_thread  # noqa: F401

EXP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "experiments")
DELTA = 2.0 ** -20
T_RTOL = 2e-6
STEPS = 3


@pytest.fixture(scope="module")
def jmicro():
    """{experiment: the Pallas callable it builds (interpret mode), or the
    ``run`` functions it would time (E1: one a table, E6)}."""
    spec = importlib.util.spec_from_file_location(
        "tpu_micro", os.path.join(EXP, "tpu_micro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    built, timed = [], []
    real = pl.pallas_call

    def record(*a, **k):
        built.append(real(*a, interpret=True, **k))
        return built[-1]

    out = {}
    with mock.patch.object(pl, "pallas_call", record), \
            mock.patch.object(mod, "timed_slope",
                              lambda fn, lo, hi, reps=3: timed.append(fn)
                              or 1.0):
        for name in ("e1", "e3", "e4", "e5", "e6", "e7", "e8", "e9"):
            built.clear()
            timed.clear()
            getattr(mod, name)()
            out[name.upper()] = built[0] if built else list(timed)
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


def _exact(blocks, ox, chain):
    """Float64 over the clusters of ``chain``, per lane: the least accepted
    t, the relative condition number kappa of the winner's t (its
    numerator's and a's sums of |terms| over |result|: a float32
    evaluation in any order, with or without FMAs, is within a few eps
    kappa of it), and whether some triangle has its u, v, u + v, t or |a|
    within 2^-20 of an accept bound."""
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
    return best.numpy(), kappa[w, lanes].numpy(), near.numpy()


@pytest.mark.parametrize("miss", [False, True])
@pytest.mark.parametrize("exp", ["E8", "E9"])
def test_leaf_matches_jax_kernel(jmicro, inp, exp, miss):
    """``miss``: lane 0's o1 is NaN, so it never hits and the chain runs on
    int(1e30), saturated to 2147483647."""
    blocks, x = inp["blocks"][:um.LEAF_CLUSTERS], inp["x"].clone()
    if miss:
        x[0, 0] = float("nan")
    jb, jx = _j(blocks), _j(x)
    # the TPU kernel's best after each step: its chain of clusters
    jbest = [np.asarray(jmicro[exp](_steps(s), jb, jx)).reshape(-1)
             for s in range(1, STEPS + 1)]
    trail = []
    got = um._leaf_ref(blocks, x, STEPS, um.LEAF_MODES[exp], trail)
    assert torch.equal(um.leaf_chain(blocks, x, STEPS, exp), got)
    chain = [int(c) for c in trail]
    jchain = [0]
    for b in jbest[:-1]:
        lane0 = 2 ** 31 - 1 if b[0] >= 2.0 ** 31 else int(b[0])
        jchain.append((jchain[-1] * 5 + lane0 % 3 + 1) % um.LEAF_CLUSTERS)
    assert chain == jchain and len(set(chain)) == STEPS
    assert (chain[1] == (2 ** 31 - 1) % 3 + 1) == miss
    want, got = jbest[-1], got.reshape(-1).numpy()
    exact, kappa, near = _exact(blocks, x, chain)
    hit_j, hit_p = want < um.FAR, got < um.FAR
    both = hit_j & hit_p
    rtol = np.maximum(T_RTOL, 4 * 2.0 ** -24 * kappa)[both]
    assert (np.abs(got - want)[both] <= rtol * want[both]).all()
    assert (np.abs(got - exact)[both] <= rtol * exact[both]).all()
    assert (got[~hit_p] == um.FAR).all() and 0 < both.sum() < both.size
    differ = hit_j != hit_p
    assert differ.sum() <= 8 and not (differ & ~near).any(), \
        f"{differ.sum()} lanes' hits differ, {(differ & ~near).sum()} " \
        "with no triangle near an accept bound"


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
