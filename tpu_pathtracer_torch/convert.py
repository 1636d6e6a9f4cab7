"""Carry a scene and a camera across from the JAX package.

The JAX package's scene and camera, read out as numpy arrays, become the
port's. This is how the tests render exactly the scene the reference
renders: build it there, convert it, render both.

``fields`` is a dict keyed by the JAX ``Scene`` field names (with
``materials`` a dict keyed by the ``Materials`` field names and ``mesh``
None or a dict keyed by the ``MeshData`` field names, its ``brute`` a
tuple of arrays and its ``bvh4`` None or a dict keyed by the JAX
``Bvh4Data`` field names), or by the JAX ``Camera`` attribute names;
values are numpy arrays, Python scalars or ``None``. The BVH4 tables'
TPU DMA ``blocks`` are not carried: the port's kernels read a triangle
table made from the feature rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_pathtracer_torch.camera import Camera
from tpu_pathtracer_torch.models.scene import Materials, MeshData, Scene
from tpu_pathtracer_torch.ops.bvh4 import Bvh4Data

_INT_FIELDS = {"mtype", "tex_id", "sphere_mat", "plane_mat", "tex_width",
               "tex_height", "mesh_id"}
_BRUTE_FIELDS = ("v0", "v1", "v2", "tex_coords", "mesh_id")


def _tensor(name, value, device):
    if value is None:
        return None
    dtype = np.int32 if name in _INT_FIELDS else np.float32
    return torch.as_tensor(np.array(value, dtype), device=device)


def bvh4_from_numpy(fields: dict, device) -> Bvh4Data:
    """A :class:`Bvh4Data` on ``device`` from the JAX tables' fields."""
    t = lambda a, dt: torch.as_tensor(np.array(a, dt), device=device)
    quant = bool(fields["quant"])
    qp = fields.get("qparams")
    return Bvh4Data(
        bounds=t(fields["bounds"], np.int32 if quant else np.float32),
        refs=t(fields["refs"], np.int32),
        tri_feat=t(fields["tri_feat"], np.float32),
        tri_map=t(fields["tri_map"], np.int32),
        n_nodes=int(fields["n_nodes"]),
        width=int(fields["width"]), stack_cap=int(fields["stack_cap"]),
        quant=quant, qparams=None if qp is None else t(qp, np.float32))


def mesh_from_numpy(fields: dict, device) -> MeshData:
    """A :class:`MeshData` on ``device`` from the JAX mesh's fields."""
    bvh4 = fields.get("bvh4")
    if bvh4 is not None:
        bvh4 = bvh4_from_numpy(bvh4, device)
    brute = fields.get("brute")
    if brute is not None:
        brute = tuple(_tensor(k, a, device)
                      for k, a in zip(_BRUTE_FIELDS, brute))
    kw = {f.name: _tensor(f.name, fields[f.name], device)
          for f in dataclasses.fields(MeshData)
          if f.name not in ("first_leaf", "prims_per_leaf", "bvh4",
                            "brute")}
    return MeshData(first_leaf=int(fields["first_leaf"]),
                    prims_per_leaf=int(fields["prims_per_leaf"]),
                    bvh4=bvh4, brute=brute, **kw)


def scene_from_numpy(fields: dict, device) -> Scene:
    """A :class:`Scene` on ``device`` from the JAX scene's fields."""
    mesh = fields.get("mesh")
    if mesh is not None:
        mesh = mesh_from_numpy(mesh, device)
    mats = fields["materials"]
    materials = Materials(**{
        f.name: _tensor(f.name, mats[f.name], device)
        for f in dataclasses.fields(Materials)})
    kw = {f.name: _tensor(f.name, fields[f.name], device)
          for f in dataclasses.fields(Scene)
          if f.name not in ("materials", "mesh", "use_nee", "sky_mode")}
    return Scene(materials=materials, mesh=mesh,
                 use_nee=bool(fields["use_nee"]),
                 sky_mode=int(fields["sky_mode"]), **kw)


def camera_from_numpy(fields: dict, device) -> Camera:
    """A :class:`Camera` on ``device`` from the JAX camera's fields."""
    return Camera(**{name: torch.as_tensor(np.array(fields[name], np.float32),
                                           device=device)
                     for name in Camera._fields})
