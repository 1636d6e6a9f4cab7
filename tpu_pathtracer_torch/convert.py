"""Carry a scene and a camera across from the JAX package.

The JAX package's scene and camera, read out as numpy arrays, become the
port's. This is how the tests render exactly the scene the reference
renders: build it there, convert it, render both.

``fields`` is a dict keyed by the JAX ``Scene`` field names (with
``materials`` a dict keyed by the ``Materials`` field names), or by the
JAX ``Camera`` attribute names; values are numpy arrays, Python scalars
or ``None``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_pathtracer_torch.camera import Camera
from tpu_pathtracer_torch.models.scene import Materials, Scene

_INT_FIELDS = {"mtype", "tex_id", "sphere_mat", "plane_mat", "tex_width",
               "tex_height"}


def _tensor(name, value, device):
    if value is None:
        return None
    dtype = np.int32 if name in _INT_FIELDS else np.float32
    return torch.as_tensor(np.array(value, dtype), device=device)


def scene_from_numpy(fields: dict, device) -> Scene:
    """A :class:`Scene` on ``device`` from the JAX scene's fields."""
    if fields.get("mesh") is not None:
        raise NotImplementedError("slice 2: meshes are not ported yet")
    mats = fields["materials"]
    materials = Materials(**{
        f.name: _tensor(f.name, mats[f.name], device)
        for f in dataclasses.fields(Materials)})
    kw = {f.name: _tensor(f.name, fields[f.name], device)
          for f in dataclasses.fields(Scene)
          if f.name not in ("materials", "mesh", "use_nee", "sky_mode")}
    return Scene(materials=materials, mesh=None,
                 use_nee=bool(fields["use_nee"]),
                 sky_mode=int(fields["sky_mode"]), **kw)


def camera_from_numpy(fields: dict, device) -> Camera:
    """A :class:`Camera` on ``device`` from the JAX camera's fields."""
    return Camera(**{name: torch.as_tensor(np.array(fields[name], np.float32),
                                           device=device)
                     for name in Camera._fields})
