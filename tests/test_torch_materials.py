"""The port's branchless BSDF ``scatter`` against the JAX package's on the
same seeded inputs, one case per material family, with lanes both inside
and outside."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.models import scene as jsc
from tpu_pathtracer.ops import materials as jm
from tpu_pathtracer.ops.v3 import V3 as JV3
from tpu_pathtracer_torch.models import scene as tsc
from tpu_pathtracer_torch.ops import materials as tm
from tpu_pathtracer_torch.ops.v3 import V3
from torch_threads import one_torch_thread  # noqa: F401

N = 2048
# sin/cos/log/exp/pow differ between XLA's and PyTorch's CPU kernels by a
# few ulps; on unit-scale directions and throughputs 1e-5 covers that
ATOL = 1e-5
FAMILIES = ["DIFFUSE", "METAL", "GLASS", "COAT", "SSS_DIELECTRIC", "SSS",
            "CHECKER"]


def _inputs(mtype, seed):
    rng = np.random.RandomState(seed)

    def unit():
        a = rng.normal(size=(N, 3))
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(
            np.float32)

    wo, nrm = unit(), unit()
    nrm = np.where((wo * nrm).sum(1, keepdims=True) > 0, -nrm, nrm)
    f = lambda *shape, lo=0.0, hi=1.0: rng.uniform(lo, hi, shape).astype(
        np.float32)
    return dict(
        wo=wo, normal=nrm, hit_t=f(N, lo=0.05, hi=5.0),
        hit_p=f(N, 3, lo=-4, hi=4), inside=np.arange(N) % 2 == 1,
        mtype=np.full(N, mtype, np.int32), albedo=f(N, 3), color2=f(N, 3),
        param=f(N, lo=0.0, hi=2.0), param2=f(N, lo=0.0, hi=0.5),
        absorption=f(N, 3), scatter_dist=f(N, lo=0.1, hi=2.0),
        rng_base=rng.randint(0, 2 ** 32, N, dtype=np.uint64).astype(
            np.uint32))


def _jax(x):
    if x.ndim == 2:
        return JV3(*(jnp.asarray(x[:, k]) for k in range(3)))
    return jnp.asarray(x)


def _torch(x):
    if x.dtype == np.uint32:
        return torch.from_numpy(x.astype(np.int64))
    if x.ndim == 2:
        return V3(*(torch.from_numpy(np.ascontiguousarray(x[:, k]))
                    for k in range(3)))
    return torch.from_numpy(x)


def test_family_constants_match():
    for name in FAMILIES:
        assert getattr(tsc, name) == getattr(jsc, name)


@pytest.mark.parametrize("family", FAMILIES)
def test_scatter_matches_jax(family):
    kw = _inputs(getattr(jsc, family), seed=FAMILIES.index(family))
    j = jm.scatter(**{k: _jax(v) for k, v in kw.items()})
    t = tm.scatter(**{k: _torch(v) for k, v in kw.items()})
    for field in ("wi", "throughput"):
        for a, b in zip(getattr(j, field), getattr(t, field)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=ATOL, err_msg=field)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(t.specular.numpy(), np.asarray(j.specular))
    np.testing.assert_array_equal(t.refracted.numpy(),
                                  np.asarray(j.refracted))
    # both outcomes of the Fresnel / free-flight choice are exercised
    if family in ("GLASS", "SSS_DIELECTRIC", "SSS"):
        assert 0 < t.refracted.numpy().mean() < 1
    if family == "COAT":
        assert 0 < t.specular.numpy().mean() < 1
