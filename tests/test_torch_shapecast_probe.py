"""The shape-cast probe of the port
(``tpu_pathtracer_torch/experiments/shapecast_probe.py``, K26): its 15
cases against the TPU file's (``experiments/shapecast_probe.py``,
``CASES``): the names in order, each case's result r against the JAX
function's, and each sum against the one ``main``'s kernel writes, run in
interpret mode.

The TPU file guards its ``main()`` and is imported by its path. All 15
kernels run in one interpret-mode ``pallas_call`` (one trace).

Tolerances. Every r and sum is exact except the A @ B^T case's: its
entries sum 1024 products of bf16 values (each exact in float32) of up to
~1.0e6, past 2²⁴, so the last bits depend on the order of summation. A
sum of n non-negative terms in float32 lies within (n - 1)·2⁻²⁴ of its
exact value relative, in any order: an entry (n = 1024) and then the sum
of the 1024 entries of the slice each add that, so each side lies within
2·1023·2⁻²⁴ of the exact float64 value and the two within twice that.
The CUDA kernel runs only on a card: ``tests/test_torch_cuda.py`` holds it
bit for bit against this plain version.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_pathtracer_torch.experiments import shapecast_probe as sc
from torch_threads import one_torch_thread  # noqa: F401

EXP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "experiments")
ABT = "dot_general rhs-contract-dim1 (A @ B^T)"
SIDE_RTOL = 2 * 1023 * 2.0 ** -24   # one side against the exact sum
PAIR_RTOL = 2 * SIDE_RTOL           # JAX against the port
SUMS = (1047552, 1047552, 523776, 1047552, 523776, 1047552, 1040384,
        14565376, None, 65024, 523776, 56448, 523776, 523776, 8)


@pytest.fixture(scope="module")
def jsc():
    spec = importlib.util.spec_from_file_location(
        "shapecast_probe", os.path.join(EXP, "shapecast_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_sums(jsc):
    """Each case's sum as the TPU file's kernel writes it (:129-133), all
    15 in one interpret-mode call: [15] float32."""
    fns = list(jsc.CASES.values())

    def kern(x_ref, *o_refs):
        for fn, o_ref in zip(fns, o_refs):
            r = fn(x_ref[:, :])
            tot = jnp.sum(r.astype(jnp.float32))
            o_ref[:, :] = jnp.full((8, 128), tot, jnp.float32)

    x = jnp.arange(1024, dtype=jnp.float32).reshape(8, 128)
    out = pl.pallas_call(
        kern, out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.float32)]
        * len(fns), interpret=True)(x)
    out = np.stack([np.asarray(a) for a in out])
    assert (out == out[:, :1, :1]).all()
    return out[:, 0, 0]


def _exact_abt():
    """The A @ B^T case's sum in float64: 1024 entries of sum bf16(k)²."""
    b = torch.arange(1024, dtype=torch.float32).to(torch.bfloat16).double()
    return 1024 * float((b * b).sum())


def test_cases_are_the_tpu_files_in_order(jsc):
    assert sc.NAMES == tuple(jsc.CASES)
    assert len(sc.NAMES) == len(sc.CASE_FLOPS) == 15


@pytest.mark.parametrize("name", list(sc.CASES))
def test_case_result_matches_jax(jsc, name):
    """r itself: the shape and every element (the dots on the [:8, :128]
    slice that enters the sum)."""
    x = sc.probe_x("cpu")
    got = sc.CASES[name](x).numpy()
    want = np.asarray(jsc.CASES[name](jnp.asarray(x.numpy())),
                      dtype=np.float32)
    assert got.shape == want.shape
    if name == ABT:
        np.testing.assert_allclose(got, want, rtol=PAIR_RTOL / 2, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_sums_match_jax(jax_sums):
    plain = sc.shapecast(sc.probe_x("cpu"))
    assert plain.shape == (15, 8, 128)
    assert (plain == plain[:, :1, :1]).all()
    plain = plain[:, 0, 0].numpy()
    for k, name in enumerate(sc.NAMES):
        if name == ABT:
            exact = _exact_abt()
            for side in (plain[k], jax_sums[k]):
                assert abs(float(side) - exact) <= SIDE_RTOL * exact
            assert abs(float(plain[k]) - float(jax_sums[k])) \
                <= PAIR_RTOL * exact
        else:
            assert plain[k] == jax_sums[k] == SUMS[k], name


def test_case_sum_order():
    """case_sum adds strided partials, then halves them pairwise: 2^24 +
    1 + 1 where the two ones meet first (partials 1 and 3 at h = 2), so
    neither is lost, where a sum in index order loses both."""
    r = torch.zeros(1024)
    r[0], r[1], r[3] = 2.0 ** 24, 1.0, 1.0
    assert sc.case_sum(r).item() == 2.0 ** 24 + 2
    seq = np.float32(0)
    for v in r.numpy():
        seq = np.float32(seq + v)
    assert seq == 2.0 ** 24


def test_wrapper_runs_a_range_of_cases():
    x = sc.probe_x("cpu")
    every = sc.shapecast(x)
    some = sc.shapecast(x, 7, 3)
    assert some.shape == (3, 8, 128)
    assert torch.equal(some, every[7:10])
    for first, count in ((-1, 1), (14, 2), (0, 16)):
        with pytest.raises(ValueError, match="outside"):
            sc.shapecast(x, first, count)
