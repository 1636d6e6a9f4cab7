"""Batched ray–triangle test and the slab test's inner t_min (counterpart
of the Möller–Trumbore and bbox parts of ``tpu_pathtracer/ops/intersect.py``).

The sphere, plane and light-sphere tests live with the kernel
(``ops/cuda_spheres.py``) and the engine (``engine/wavefront.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_pathtracer_torch.ops.vec import FLT_MAX

# The reference's inner slab t_min (intersections.h:8, :26).
BBOX_T_MIN = 0.001


def _cross(a, b):
    return (a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def triangles_hit(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
                  origin: torch.Tensor, direction: torch.Tensor,
                  t_min, t_max
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Möller–Trumbore (intersections.h:54–83), broadcast over any batch,
    in the restructured form of the JAX package: a = −(d·n), u = f(q·e2),
    v = −f(q·e1), t = f(s·n) with n = e1×e2 and q = s×d.

    ``v0/v1/v2``, ``origin``, ``direction`` broadcast to a common
    ``[..., 3]``; ``t_min``/``t_max`` broadcast to the batch shape.
    Returns (t, u, v) with t = FLT_MAX on a miss. Degenerate and sentinel
    (non-finite) triangles miss.
    """
    eps = 1e-7  # intersections.h:55
    edge1 = v1 - v0
    edge2 = v2 - v0
    nrm = _cross(edge1, edge2)
    d = (direction[..., 0], direction[..., 1], direction[..., 2])
    a = -_dot(d, nrm)
    parallel = torch.abs(a) < eps
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = origin - v0
    q = _cross(s, direction)
    e1 = (edge1[..., 0], edge1[..., 1], edge1[..., 2])
    e2 = (edge2[..., 0], edge2[..., 1], edge2[..., 2])
    u = f * _dot(q, e2)
    v = -(f * _dot(q, e1))
    t = f * _dot((s[..., 0], s[..., 1], s[..., 2]), nrm)
    bad = (parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
           | ~(t > t_min) | ~(t < t_max) | ~torch.isfinite(t))
    return torch.where(bad, FLT_MAX, t), u, v
