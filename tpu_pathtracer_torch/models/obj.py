"""Wavefront OBJ mesh loading (counterpart of
``tpu_pathtracer/models/obj.py``): load an OBJ, build its BVH and
assemble a renderable scene."""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpu_pathtracer_torch.camera import make_camera
from tpu_pathtracer_torch.models.scene import (DIFFUSE, SKY_CONST,
                                               make_materials, make_scene)
from tpu_pathtracer_torch.ops.bvh import build_bvh


def load_obj(path: str):
    """Parse vertices/texcoords/faces from an OBJ file.

    Supports v / vt / f records with v, v/vt, v//vn and v/vt/vn forms;
    polygons are fan-triangulated. Returns (v0, v1, v2, tex_coords)
    float32 arrays.
    """
    verts = []
    texs = []
    faces = []  # list of [(vi, ti), ...]
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                texs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                corners = []
                for tok in parts[1:]:
                    comp = tok.split("/")
                    vi = int(comp[0])
                    vi = vi - 1 if vi > 0 else len(verts) + vi
                    ti = -1
                    if len(comp) > 1 and comp[1]:
                        ti = int(comp[1])
                        ti = ti - 1 if ti > 0 else len(texs) + ti
                    corners.append((vi, ti))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    faces.append([corners[0], corners[k], corners[k + 1]])

    v = np.asarray(verts, np.float32)
    t = np.asarray(texs, np.float32) if texs else np.zeros((0, 2),
                                                           np.float32)
    n = len(faces)
    v0 = np.zeros((n, 3), np.float32)
    v1 = np.zeros((n, 3), np.float32)
    v2 = np.zeros((n, 3), np.float32)
    tc = np.zeros((n, 6), np.float32)
    for i, face in enumerate(faces):
        (a, ta), (b, tb), (c, tcix) = face
        v0[i], v1[i], v2[i] = v[a], v[b], v[c]
        for j, ti in enumerate((ta, tb, tcix)):
            if 0 <= ti < len(t):
                tc[i, 2 * j:2 * j + 2] = t[ti]
    return v0, v1, v2, tc


def load_obj_scene(path: str, nx: int, ny: int,
                   material: Optional[dict] = None,
                   prims_per_leaf: int = 64, use_nee: bool = True,
                   device="cuda"):
    """OBJ → BVH → renderable scene with an auto-framed camera: on the +z
    side looking at the mesh center at a distance framing its bounding
    sphere, with the NEE light above-right, scaled to the scene. Returns
    (scene, camera)."""
    v0, v1, v2, tc = load_obj(path)
    mesh_ids = np.zeros((v0.shape[0],), np.int32)
    mesh = build_bvh(v0, v1, v2, tc, mesh_ids, prims_per_leaf=prims_per_leaf,
                     device=device)
    mats = make_materials([material or dict(type=DIFFUSE,
                                            color=(0.65, 0.6, 0.5))],
                          device=device)

    lo = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(axis=0)
    center = (lo + hi) / 2.0
    radius = float(np.linalg.norm(hi - lo) / 2.0)
    cam = make_camera(center + np.array([0.0, 0.4, 2.6]) * radius, center,
                      (0.0, 1.0, 0.0), 40.0, nx / ny, device=device)
    scene = make_scene(
        mats, mesh=mesh,
        light_center=tuple(center + np.array([1.5, 3.0, 1.0]) * radius),
        light_radius=0.5 * radius,
        light_color=(20.0, 20.0, 20.0),
        use_nee=use_nee, sky_mode=SKY_CONST)
    return scene, cam
