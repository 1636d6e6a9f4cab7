"""The port's single-node stackless walk (``ops/bvh.py``
``traverse_single_node``) against the JAX package's, on the random mesh
and rays of ``tests/test_bvh.py:136``, and against the port's dual-node
``traverse``."""

import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import bvh as jbvh
from tpu_pathtracer.ops.vec import FLT_MAX
from test_bvh import _random_rays, _random_tris
from tpu_pathtracer_torch.ops import bvh as tbvh


def _inputs():
    v0, v1, v2 = _random_tris(400, seed=9)
    o, d = _random_rays(300, seed=10)
    return ((jbvh.build_bvh(v0, v1, v2, prims_per_leaf=5),
             tbvh.build_bvh(v0, v1, v2, prims_per_leaf=5, device="cpu")),
            (o, d), (torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d))))


@pytest.mark.parametrize("shadow", [False, True])
def test_single_node_equals_jax(shadow):
    """Winners, hits and the step counts equal; t, u and v to XLA's CPU
    FMA contraction (ROADMAP C-2), the bounds of
    ``test_brute_force_equals_jax`` (tests/test_torch_mesh.py:276)."""
    (jm, tm), (jo, jd), (o, d) = _inputs()
    exp = jbvh.traverse_single_node(jm, jo, jd, 1e-3, FLT_MAX,
                                    is_shadow=shadow)
    got = tbvh.traverse_single_node(tm, o, d, 1e-3, float(FLT_MAX),
                                    is_shadow=shadow)
    idx = got.tri_id.numpy()
    assert got.tri_id.dtype == torch.int32
    np.testing.assert_array_equal(idx, np.asarray(exp.tri_id))
    hit = idx >= 0
    assert hit.sum() > 30
    assert got.nodes_both == int(exp.nodes_both) == 0
    assert got.nodes_single == int(exp.nodes_single) > 0
    np.testing.assert_allclose(got.t.numpy(), np.asarray(exp.t), rtol=1e-5)
    for a, b in ((got.u, exp.u), (got.v, exp.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   atol=1e-5)


def test_single_node_equals_dual_node():
    """Hits do not depend on the traversal order: t and the winners equal
    the port's dual-node walk bit for bit, and shadow rays are occluded
    on the same lanes."""
    (_, tm), _, (o, d) = _inputs()
    single = tbvh.traverse_single_node(tm, o, d, 1e-3, float(FLT_MAX))
    dual = tbvh.traverse(tm, o, d, 1e-3, float(FLT_MAX))
    np.testing.assert_array_equal(single.t.numpy(), dual.t.numpy())
    np.testing.assert_array_equal(single.tri_id.numpy(),
                                  dual.tri_id.numpy())
    sh_s = tbvh.traverse_single_node(tm, o, d, 1e-3, float(FLT_MAX),
                                     is_shadow=True)
    sh_d = tbvh.traverse(tm, o, d, 1e-3, float(FLT_MAX), is_shadow=True)
    np.testing.assert_array_equal(sh_s.tri_id.numpy() >= 0,
                                  sh_d.tri_id.numpy() >= 0)
    # one box fetch a step, but more steps than dual-node descents
    assert single.nodes_single > dual.nodes_both
    # a per-ray t_max is respected
    hit = single.tri_id >= 0
    capped = tbvh.traverse_single_node(
        tm, o, d, 1e-3, torch.where(hit, single.t * 0.5, 1e30))
    assert not ((capped.tri_id >= 0) & hit & (capped.t >= single.t)).any()
