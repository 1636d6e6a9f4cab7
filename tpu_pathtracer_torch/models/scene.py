"""SoA scene data model (counterpart of ``tpu_pathtracer/models/scene.py``).

The containers hold tensors on one device: the material table, the
analytic spheres, the triangle mesh with its implicit-heap BVH, the floor
plane, the sphere light and the texture atlas.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# material_type (helper_structs.h:127–131) plus preset-only BSDF families.
DIFFUSE = 0
METAL = 1
GLASS = 2
COAT = 3
SSS_DIELECTRIC = 4
SSS = 5
CHECKER = 6

# objId enum (kernels.cu:40–45) plus SPHERE.
OBJ_NONE = 0
OBJ_TRIMESH = 1
OBJ_PLANE = 2
OBJ_LIGHT = 3
OBJ_SPHERE = 4

# Sky models: constant (kernels.cu:424) and the RTiOW gradient.
SKY_CONST = 0
SKY_GRADIENT = 1


@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA material table.

    color doubles as: albedo (DIFFUSE), tint (METAL/GLASS), base color
    (COAT). param: fuzz (METAL), ior (GLASS/COAT/SSS_DIELECTRIC), checker
    frequency (CHECKER). param2: fuzz for COAT/GLASS presets.
    """
    mtype: torch.Tensor         # [M] int32
    color: torch.Tensor         # [M,3] f32
    color2: torch.Tensor        # [M,3] f32 (checker alt color)
    param: torch.Tensor         # [M] f32
    param2: torch.Tensor        # [M] f32
    absorption: torch.Tensor    # [M,3] f32 Beer–Lambert sigma
    scatter_dist: torch.Tensor  # [M] f32 SSS mean free path
    tex_id: torch.Tensor        # [M] int32, -1 = none

    @property
    def count(self) -> int:
        return self.mtype.shape[0]


def make_materials(rows, device) -> Materials:
    """rows: list of dicts with keys type, color, and optional color2,
    param, param2, absorption, scatter_dist, tex_id."""
    m = len(rows)

    def col(key, default, width=None):
        a = np.asarray([r.get(key, default) for r in rows], np.float32)
        return a.reshape((m, width)) if width else a

    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    i = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    return Materials(
        mtype=i([r["type"] for r in rows]),
        color=f(col("color", (0.0, 0.0, 0.0), 3)),
        color2=f(col("color2", (0.0, 0.0, 0.0), 3)),
        param=f(col("param", 0.0)),
        param2=f(col("param2", 0.0)),
        absorption=f(col("absorption", (0.0, 0.0, 0.0), 3)),
        scatter_dist=f(col("scatter_dist", 1.0)),
        tex_id=i([int(r.get("tex_id", -1)) for r in rows]),
    )


@dataclasses.dataclass(frozen=True)
class MeshData:
    """Triangle mesh + implicit-heap BVH, SoA.

    The BVH layout matches the reference's invariants (kernels.cu:614,
    :199–203): a complete binary tree indexed from 1, ``first_leaf =
    num_nodes // 2``, leaf ``i`` covering triangles
    ``[(i - first_leaf) * prims_per_leaf, +prims_per_leaf)`` with padding
    (non-finite sentinel triangles that never hit).
    """
    v0: torch.Tensor           # [T,3] f32
    v1: torch.Tensor           # [T,3] f32
    v2: torch.Tensor           # [T,3] f32
    tex_coords: torch.Tensor   # [T,6] f32 (t0u,t0v,t1u,t1v,t2u,t2v)
    mesh_id: torch.Tensor      # [T] int32, material index
    bvh_min: torch.Tensor      # [Nn,3] f32
    bvh_max: torch.Tensor      # [Nn,3] f32
    bounds_min: torch.Tensor   # [3] f32
    bounds_max: torch.Tensor   # [3] f32
    first_leaf: int
    prims_per_leaf: int
    # SAH BVH4 tables (ops.bvh4.Bvh4Data) when the mesh takes that tier
    bvh4: Optional[object] = None
    # the live triangles without the heap's interleaved sentinel padding,
    # (v0, v1, v2, tex_coords, mesh_id), for the brute-force kernel; set
    # by ops.bvh.build_bvh for meshes small enough to take that path
    brute: Optional[tuple] = None

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass(frozen=True)
class Scene:
    """Unified scene: optional sphere set, optional mesh, optional floor
    plane, sphere light, sky."""
    materials: Materials
    sphere_center: Optional[torch.Tensor]  # [S,3]
    sphere_radius: Optional[torch.Tensor]  # [S]
    sphere_mat: Optional[torch.Tensor]     # [S] int32
    mesh: Optional[MeshData]
    plane_point: Optional[torch.Tensor]    # [3]
    plane_norm: Optional[torch.Tensor]     # [3]
    plane_mat: Optional[torch.Tensor]      # [] int32
    light_center: torch.Tensor             # [3]
    light_radius: torch.Tensor             # []
    light_color: torch.Tensor              # [3]
    sky_color: torch.Tensor                # [3] (const mode)
    tex_atlas: Optional[torch.Tensor]      # [K,H,W,3]
    tex_width: Optional[torch.Tensor]      # [K] int32
    tex_height: Optional[torch.Tensor]     # [K] int32
    use_nee: bool
    sky_mode: int

    @property
    def has_spheres(self) -> bool:
        return self.sphere_center is not None

    @property
    def has_mesh(self) -> bool:
        return self.mesh is not None

    @property
    def has_plane(self) -> bool:
        return self.plane_point is not None

    @property
    def has_textures(self) -> bool:
        return self.tex_atlas is not None


def make_scene(materials: Materials,
               sphere_center=None, sphere_radius=None, sphere_mat=None,
               mesh=None,
               plane_point=None, plane_norm=None, plane_mat=None,
               light_center=(52.514355, 715.686951, -272.620972),
               light_radius=50.0,
               light_color=(20.0, 20.0, 20.0),
               sky_color=(0.5, 0.5, 0.5),
               tex_atlas=None, tex_width=None, tex_height=None,
               use_nee=True, sky_mode=SKY_CONST) -> Scene:
    """Scene factory on ``materials``' device. Light defaults are the
    reference's hardcoded sphere light (kernels.cu:93–94); the sky
    default is the constant 0.5 sky (kernels.cu:424)."""
    device = materials.mtype.device

    def f32(x):
        if x is None:
            return None
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        if x is None:
            return None
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return Scene(
        materials=materials,
        sphere_center=f32(sphere_center),
        sphere_radius=f32(sphere_radius),
        sphere_mat=i32(sphere_mat),
        mesh=mesh,
        plane_point=f32(plane_point),
        plane_norm=f32(plane_norm),
        plane_mat=i32(plane_mat),
        light_center=f32(light_center),
        light_radius=f32(light_radius),
        light_color=f32(light_color),
        sky_color=f32(sky_color),
        tex_atlas=f32(tex_atlas),
        tex_width=i32(tex_width),
        tex_height=i32(tex_height),
        use_nee=bool(use_nee),
        sky_mode=int(sky_mode),
    )
