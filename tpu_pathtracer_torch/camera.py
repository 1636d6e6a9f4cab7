"""Thin-lens camera (counterpart of ``tpu_pathtracer/camera.py``).

The basis is precomputed on the host in float32 exactly as the JAX
package does it; ray generation runs over whole component-SoA pixel
batches on the camera's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tpu_pathtracer_torch.ops import rng as _rng
from tpu_pathtracer_torch.ops.v3 import V3


class Camera(NamedTuple):
    """Precomputed camera basis: [3] float32 tensors and a 0-dim
    ``lens_radius``, all on one device."""
    origin: torch.Tensor
    lower_left_corner: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    lens_radius: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.origin.device

    def generate_rays(self, pixel_id: torch.Tensor, sample, nx: int,
                      ny: int):
        """Primary-ray batch for flat pixel ids (pixel_id = j*nx + i) with
        sub-pixel jitter and lens sampling. Returns (origin, unit
        direction) as component-SoA :class:`V3` batches."""
        base = _rng.camera_base(pixel_id, sample)
        pid = pixel_id.to(torch.int64)
        i = (pid % nx).to(torch.float32)
        j = (pid // nx).to(torch.float32)
        s = (i + _rng.slot_uniform(base, _rng.S_JITTER_U)) / float(nx)
        t = (j + _rng.slot_uniform(base, _rng.S_JITTER_V)) / float(ny)

        rdx, rdy = _rng.in_unit_disk_xy(
            _rng.slot_uniform(base, _rng.S_LENS0),
            _rng.slot_uniform(base, _rng.S_LENS1))
        rdx = self.lens_radius * rdx
        rdy = self.lens_radius * rdy
        cu, cv = self.u, self.v
        offset = V3(rdx * cu[0] + rdy * cv[0],
                    rdx * cu[1] + rdy * cv[1],
                    rdx * cu[2] + rdy * cv[2])
        o = self.origin
        origin = V3(o[0] + offset.x, o[1] + offset.y, o[2] + offset.z)
        llc, h, v = self.lower_left_corner, self.horizontal, self.vertical
        direction = V3(llc[0] + s * h[0] + t * v[0] - origin.x,
                       llc[1] + s * h[1] + t * v[1] - origin.y,
                       llc[2] + s * h[2] + t * v[2] - origin.z)
        # the ray constructor normalizes its direction (ray.h:9)
        return origin, direction.normalized()


def _unit(a: np.ndarray) -> np.ndarray:
    """float32 normalize as the JAX package's ``unit_vector`` (rsqrt of
    the clamped squared length)."""
    sq = np.float32(np.sum(a * a, dtype=np.float32))
    return (a * np.float32(1.0 / math.sqrt(max(sq, np.float32(1e-20))))
            ).astype(np.float32)


def make_camera(lookfrom, lookat, vup, vfov_deg: float, aspect: float,
                aperture: float = 0.0, focus_dist: float | None = None,
                device="cpu") -> Camera:
    """Build a camera exactly as helper_structs.h:194–206 (vfov is the full
    vertical field of view in degrees, top to bottom)."""
    f32 = np.float32
    lookfrom = np.asarray(lookfrom, f32)
    lookat = np.asarray(lookat, f32)
    vup = np.asarray(vup, f32)
    if focus_dist is None:
        focus_dist = float(np.linalg.norm(lookfrom - lookat))
    theta = vfov_deg * math.pi / 180.0
    half_height = math.tan(theta / 2.0)
    half_width = aspect * half_height
    w = _unit(lookfrom - lookat)
    u = _unit(np.cross(vup, w).astype(f32))
    v = np.cross(w, u).astype(f32)
    origin = lookfrom
    hw = f32(half_width * focus_dist)
    hh = f32(half_height * focus_dist)
    fd = f32(focus_dist)
    lower_left_corner = origin - hw * u - hh * v - fd * w
    horizontal = f32(2.0 * half_width * focus_dist) * u
    vertical = f32(2.0 * half_height * focus_dist) * v
    t = lambda a: torch.as_tensor(np.asarray(a, f32), device=device)
    return Camera(t(origin), t(lower_left_corner), t(horizontal),
                  t(vertical), t(u), t(v), t(w), t(aperture / 2.0))


def staircase_camera(nx: int, ny: int, device="cpu") -> Camera:
    """The staircase scene's camera (staircase_scene.h:62–73)."""
    lookfrom = (5.555139, 173.679901, 494.515045)
    lookat = (5.555139, 173.679901, 493.515045)
    return make_camera(lookfrom, lookat, (0.0, 1.0, 0.0), 42.0,
                       float(nx) / float(ny), aperture=0.0, focus_dist=1.0,
                       device=device)
