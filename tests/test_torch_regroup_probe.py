"""The regrouped leaf phase of the port
(``tpu_pathtracer_torch/experiments/regroup_probe.py``, K21): its plain
version against the TPU kernel of ``experiments/regroup_probe.py``
(``_kernel`` through ``run_window``) in interpret mode at ``upto`` = mt and
full, against that file's own ``numpy_ref``, and against numpy
restatements of the kernel's ``ct``, ``g``, ``ray`` and ``tri`` blocks
(:134-180; the JAX runs of those four take ~30 s of interpret mode
together, so they are restated here instead), on the TPU file's seeded
inputs (``default_rng(7)``: 807 pairs, no empty visit) and on a crafted
window with empty visits.

The TPU file guards its ``main()`` and is imported by its path. Its
``_kernel`` runs at mt and at full in one interpret-mode ``pallas_call``
with ``run_window``'s specs: one trace and compile instead of two.

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

from tpu_pathtracer_torch.experiments import regroup_probe as rp
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
def jax_out(jrg, seeded):
    """{upto: (t_out, i_out)} of the TPU kernel at mt and full."""
    def both(*refs):
        for k, upto in enumerate(("mt", "full")):
            jrg._kernel(*refs[:11], *refs[11 + 2 * k:13 + 2 * k], upto=upto,
                        interpret=True)

    spec8 = pl.BlockSpec(memory_space=pltpu.VMEM)
    shapes = (jax.ShapeDtypeStruct((8, 128), jnp.float32),
              jax.ShapeDtypeStruct((8, 128), jnp.int32))
    out = pl.pallas_call(
        both, in_specs=[spec8] * 9 + [pl.BlockSpec(
            memory_space=pltpu.SMEM)] * 2,
        out_specs=(spec8,) * 4, out_shape=shapes * 2, interpret=True)(
            *map(jnp.asarray, seeded[0][:11]))
    out = [np.asarray(a) for a in out]
    return {"mt": out[:2], "full": out[2:]}


@pytest.mark.parametrize("upto", ["mt", "full"])
def test_matches_jax_kernel(seeded, jax_out, upto):
    j, inp = seeded
    tj, ij = jax_out[upto]
    tp, ip = _plain(inp, upto)
    np.testing.assert_array_equal(ip, ij)
    if upto == "mt":  # per slot: FLT_MAX where nothing was accepted
        miss = tj == np.float32(rp.FLT_MAX)
        np.testing.assert_array_equal(tp == np.float32(rp.FLT_MAX), miss)
        used = np.arange(rp.S).reshape(8, 128) < int(j[9][-1])
        assert miss[~used].all()
        assert (ip[~used] == int(j[10][-1]) * rp.W).all()
    else:
        miss = ij < 0
        assert 0 < miss.sum() < miss.size
    np.testing.assert_allclose(tp[~miss], tj[~miss], rtol=T_RTOL_JAX, atol=0)


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
