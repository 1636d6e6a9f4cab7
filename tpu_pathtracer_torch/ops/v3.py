"""Component-SoA 3-vectors over 1-D tensors (counterpart of
``tpu_pathtracer/ops/v3.py``).

A :class:`V3` holds x, y and z as three dense ``[N]`` tensors instead of
one ``[N, 3]`` tensor. On the GPU each component op is one coalesced
elementwise pass, and the layout matches the JAX package's, so every
stage reads like its counterpart there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    """Batched 3-vector in component-SoA form (each field ``[...]``)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- arithmetic -------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__
    __radd__ = __add__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return self * (1.0 / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- geometry ---------------------------------------------------------
    def dot(self, o: "V3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(self.y * o.z - self.z * o.y,
                  self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def squared_length(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return torch.sqrt(self.squared_length())

    def normalized(self, eps: float = 1e-20) -> "V3":
        return self * torch.rsqrt(torch.clamp_min(self.squared_length(), eps))

    def max3(self) -> torch.Tensor:
        """Largest component (russian-roulette survival)."""
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def exp(self) -> "V3":
        return V3(torch.exp(self.x), torch.exp(self.y), torch.exp(self.z))

    # -- conversion -------------------------------------------------------
    def stack(self) -> torch.Tensor:
        """→ [..., 3] interleaved (host-facing boundaries only)."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    @staticmethod
    def from_array(a: torch.Tensor) -> "V3":
        """[..., 3] → V3 of contiguous component tensors."""
        return V3(a[..., 0].contiguous(), a[..., 1].contiguous(),
                  a[..., 2].contiguous())

    @staticmethod
    def full(shape, vx, vy, vz, device, dtype=torch.float32) -> "V3":
        return V3(torch.full(shape, float(vx), dtype=dtype, device=device),
                  torch.full(shape, float(vy), dtype=dtype, device=device),
                  torch.full(shape, float(vz), dtype=dtype, device=device))

    @staticmethod
    def zeros(shape, device, dtype=torch.float32) -> "V3":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return V3(z, z, z)

    @staticmethod
    def ones(shape, device, dtype=torch.float32) -> "V3":
        o = torch.ones(shape, dtype=dtype, device=device)
        return V3(o, o, o)


def where(mask: torch.Tensor, a, b) -> V3:
    """Lane select; ``mask`` is [...]-shaped, ``a`` and ``b`` are V3 or
    scalars."""
    def comp(v, k):
        return getattr(v, k) if isinstance(v, V3) else v
    return V3(*(torch.where(mask, comp(a, k), comp(b, k))
                for k in ("x", "y", "z")))


def reflect(v: V3, n: V3) -> V3:
    """material.h:23–25."""
    return v - n * (2.0 * v.dot(n))


def refract(uv: V3, n: V3, etai_over_etat: torch.Tensor) -> V3:
    """material.h:15–21 (parallel-component-only under TIR)."""
    cos_theta = torch.clamp_max((-uv).dot(n), 1.0)
    r_par = (uv + n * cos_theta) * etai_over_etat
    sqlen = r_par.squared_length()
    perp = torch.where(sqlen >= 1.0, 0.0,
                       -torch.sqrt(torch.clamp_min(1.0 - sqlen, 0.0)))
    return r_par + n * perp
