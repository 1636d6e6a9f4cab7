"""The port's counter-based RNG against the JAX package's, on the same
seeded inputs: every integer function bit-equal, the samplers within a
bound that covers transcendental ulps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import rng as jr
from tpu_pathtracer_torch.ops import rng as tr

N = 4096


def _u32(seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    x[:5] = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]  # edges, >= 2^31
    return x


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same_bits(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


def test_inputs_cover_high_bit():
    assert (_u32(0) >= 2 ** 31).mean() > 0.4


@pytest.mark.parametrize("fn", ["pcg_hash", "wang_hash"])
def test_hash_bit_equal(fn):
    x = _u32(1)
    _same_bits(getattr(jr, fn)(jnp.asarray(x)), getattr(tr, fn)(_t(x)))


@pytest.mark.parametrize("b_kind", ["array", "int", "high_int"])
def test_combine_bit_equal(b_kind):
    a = _u32(2)
    b = {"array": _u32(3), "int": 12345, "high_int": 0xDEADBEEF}[b_kind]
    jb = jnp.asarray(b, jnp.uint32) if b_kind == "array" else b
    tb = _t(b) if b_kind == "array" else b
    _same_bits(jr._combine(jnp.asarray(a), jb), tr._combine(_t(a), tb))


def test_bounce_and_camera_base_bit_equal():
    pix, smp = _u32(4), _u32(5) % 100000
    bounce = (_u32(6) % 64).astype(np.int32)
    _same_bits(jr.bounce_base(jnp.asarray(pix), jnp.asarray(smp),
                              jnp.asarray(bounce)),
               tr.bounce_base(_t(pix), _t(smp), _t(bounce)))
    _same_bits(jr.camera_base(jnp.asarray(pix), jnp.asarray(smp)),
               tr.camera_base(_t(pix), _t(smp)))
    # scalar sample / bounce, as the plain engine passes them
    _same_bits(jr.bounce_base(jnp.asarray(pix), jnp.uint32(7), jnp.int32(3)),
               tr.bounce_base(_t(pix), 7, 3))


def test_wrapped_sample_matches_uint32():
    """The regen engine computes sample - 1 for lanes that have not
    started; uint32 wraps it to 2^32 - 1 and so must the int64 port."""
    pix = _u32(7)
    _same_bits(jr.bounce_base(jnp.asarray(pix), jnp.uint32(0xFFFFFFFF),
                              jnp.int32(0)),
               tr.bounce_base(_t(pix), _t(np.full(N, -1)), 0))


@pytest.mark.parametrize("slot", range(jr.NUM_BOUNCE_SLOTS))
def test_slot_uniform_bit_equal(slot):
    base = _u32(8)
    j = np.asarray(jr.slot_uniform(jnp.asarray(base), slot))
    t = tr.slot_uniform(_t(base), slot).numpy()
    assert t.dtype == np.float32
    np.testing.assert_array_equal(j, t)


def test_uniform_blocks_bit_equal():
    pix, smp = _u32(9), _u32(10) % 1000
    np.testing.assert_array_equal(
        np.asarray(jr.bounce_uniforms(jnp.asarray(pix), jnp.asarray(smp),
                                      jnp.uint32(2))),
        tr.bounce_uniforms(_t(pix), _t(smp), 2).numpy())
    np.testing.assert_array_equal(
        np.asarray(jr.camera_uniforms(jnp.asarray(pix), jnp.asarray(smp))),
        tr.camera_uniforms(_t(pix), _t(smp)).numpy())


def _uniforms(seed, k):
    rng = np.random.RandomState(seed)
    u = rng.rand(k, N).astype(np.float32)
    u[:, :3] = np.array([0.0, 0.5, 1 - 2 ** -24], np.float32)  # edges
    return u


# torch has no cbrt and its sin/cos/pow differ from XLA's by a few ulps:
# 2e-6 absolute on values of magnitude <= 1 covers that.
SAMPLER_ATOL = 2e-6


@pytest.mark.parametrize("name,k", [("in_unit_sphere", 3),
                                    ("on_unit_sphere", 2),
                                    ("in_unit_disk", 2)])
def test_samplers_close(name, k):
    u = _uniforms(11, k)
    j = np.asarray(getattr(jr, name)(*(jnp.asarray(a) for a in u)))
    t = getattr(tr, name)(*(torch.from_numpy(a) for a in u)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=SAMPLER_ATOL)


def test_soa_samplers_close():
    u = _uniforms(12, 3)
    j = jr.in_unit_sphere_v3(*(jnp.asarray(a) for a in u))
    t = tr.in_unit_sphere_v3(*(torch.from_numpy(a) for a in u))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=SAMPLER_ATOL)
    jx, jy = jr.in_unit_disk_xy(jnp.asarray(u[0]), jnp.asarray(u[1]))
    tx, ty = tr.in_unit_disk_xy(torch.from_numpy(u[0]),
                                torch.from_numpy(u[1]))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=SAMPLER_ATOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=SAMPLER_ATOL)
