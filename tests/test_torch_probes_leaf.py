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
from torch_threads import one_torch_thread  # noqa: F401

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
