"""Counter-based RNG + closed-form samplers (counterpart of
``tpu_pathtracer/ops/rng.py``).

Every draw is a pure function of ``(pixel_id, sample, bounce, slot)``, so
the port reproduces each path's random numbers exactly: the tests hold
the integer functions bit-equal to the JAX package's.

The hashes are uint32 arithmetic. PyTorch on the CPU implements no
uint32 ``+``, ``>>`` or ``<<``, so the integers here are int64 holding a
value in [0, 2³²) and every sum or shift left is masked to 32 bits. The
products need no wrap: each factor is below 2³², each constant below
2³⁰, so the product fits in int64 and its low 32 bits are exact.
"""

from __future__ import annotations

import math

import torch

from tpu_pathtracer_torch.ops.v3 import V3

_M = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9

# Salts decorrelating the per-bounce draw blocks from the camera block.
SALT_CAMERA = 0x01000193
SALT_BOUNCE = 0x85EBCA6B

# Slot indices within a bounce's draw block.
S_BSDF0 = 0  # diffuse dir u1 / fresnel draw
S_BSDF1 = 1
S_BSDF2 = 2
S_BSDF3 = 3  # fuzz sphere / sss free-flight
S_BSDF4 = 4
S_BSDF5 = 5
S_NEE0 = 6
S_NEE1 = 7
S_ROULETTE = 8
NUM_BOUNCE_SLOTS = 9

# Camera block slots (jitter + lens disk).
S_JITTER_U = 0
S_JITTER_V = 1
S_LENS0 = 2
S_LENS1 = 3
NUM_CAMERA_SLOTS = 4


def _u32(x):
    """An integer tensor → int64 holding its low 32 bits; a Python int →
    its low 32 bits (negative ints wrap as uint32 would)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M
    return x & _M


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG-RXS-M-XS output permutation over an LCG step (uint32 → uint32)."""
    state = (_u32(x) * 747796405 + 2891336453) & _M
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M
    return (word >> 22) ^ word


def wang_hash(x: torch.Tensor) -> torch.Tensor:
    """Wang hash, kept for parity with the reference's seeder."""
    x = _u32(x)
    x = x ^ 61 ^ (x >> 16)
    x = (x * 9) & _M
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _M
    x = x ^ (x >> 15)
    return x


def _combine(a: torch.Tensor, b) -> torch.Tensor:
    """boost-style hash_combine with a pcg finisher; ``b`` is a tensor or
    a Python int."""
    a = _u32(a)
    b = _u32(b)
    return pcg_hash(a ^ ((b + _GOLDEN + ((a << 6) & _M) + (a >> 2)) & _M))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 → float32 in [0, 1) from the top 24 bits (exact in f32)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def bounce_base(pixel_id: torch.Tensor, sample, bounce) -> torch.Tensor:
    """Per-lane base counter for one bounce's draw block."""
    return _combine(_combine(pcg_hash(pixel_id), sample),
                    _u32(bounce) + SALT_BOUNCE)


def camera_base(pixel_id: torch.Tensor, sample) -> torch.Tensor:
    """Per-lane base counter for the primary-ray draw block."""
    return _combine(_combine(pcg_hash(pixel_id), sample), SALT_CAMERA)


def slot_uniform(base: torch.Tensor, slot: int) -> torch.Tensor:
    """The ``slot``-th uniform of a draw block — a dense [N] tensor."""
    return uniform_from_bits(pcg_hash((base + ((slot * _GOLDEN) & _M)) & _M))


def _block_uniforms(base: torch.Tensor, num_slots: int) -> torch.Tensor:
    slots = (torch.arange(num_slots, device=base.device) * _GOLDEN) & _M
    return uniform_from_bits(pcg_hash((base[..., None] + slots) & _M))


def bounce_uniforms(pixel_id: torch.Tensor, sample, bounce,
                    num_slots: int = NUM_BOUNCE_SLOTS) -> torch.Tensor:
    """Draw block for one bounce: shape ``pixel_id.shape + (num_slots,)``
    (interleaved variant of :func:`slot_uniform` — same values)."""
    return _block_uniforms(bounce_base(pixel_id, sample, bounce), num_slots)


def camera_uniforms(pixel_id: torch.Tensor, sample) -> torch.Tensor:
    """Draw block for primary-ray generation: ``[..., NUM_CAMERA_SLOTS]``."""
    return _block_uniforms(camera_base(pixel_id, sample), NUM_CAMERA_SLOTS)


def in_unit_sphere_v3(u1: torch.Tensor, u2: torch.Tensor,
                      u3: torch.Tensor) -> V3:
    """Uniform point in the unit ball as component-SoA V3: direction
    uniform on the sphere (z = 1-2u, phi = 2πu) scaled by radius ∛u."""
    z = 1.0 - 2.0 * u1
    phi = (2.0 * math.pi) * u2
    s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    # torch has no cbrt: u ** (1/3) (u >= 0) can differ from the JAX
    # package's jnp.cbrt by a few ulps (the samplers' test bound)
    r = torch.pow(u3, 1.0 / 3.0)
    return V3(r * s * torch.cos(phi), r * s * torch.sin(phi), r * z)


def in_unit_disk_xy(u1: torch.Tensor, u2: torch.Tensor):
    """Uniform point in the unit disk → (x, y) component tensors."""
    r = torch.sqrt(u1)
    theta = (2.0 * math.pi) * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def in_unit_sphere(u1: torch.Tensor, u2: torch.Tensor,
                   u3: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit ball, closed form, as ``[..., 3]``."""
    return in_unit_sphere_v3(u1, u2, u3).stack()


def on_unit_sphere(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere, closed form."""
    z = 1.0 - 2.0 * u1
    phi = (2.0 * math.pi) * u2
    s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)


def in_unit_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk (z=0), closed form."""
    x, y = in_unit_disk_xy(u1, u2)
    return torch.stack([x, y, torch.zeros_like(x)], dim=-1)
