"""Triangle-mesh scenes (counterpart of ``tpu_pathtracer/models/mesh.py``):
the staircase material table, procedural staircase geometry and textures,
and scene assembly. The numpy geometry is built exactly as the JAX
package builds it, so the arrays are identical.

  * :func:`staircase_materials` — the 20-entry material table
    (staircase_scene.h:140–160);
  * :func:`load_staircase_scene` — assembly from the reference's assets
    (a ``.bvh`` plus its nine PNG textures) when present;
  * :func:`procedural_staircase_scene` — a self-contained staircase-like
    mesh (boxes forming steps, walls, floor) + procedural textures with
    the same material table, camera and light.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from tpu_pathtracer_torch.camera import staircase_camera
from tpu_pathtracer_torch.models.scene import (
    DIFFUSE, GLASS, METAL, SKY_CONST, make_materials, make_scene)
from tpu_pathtracer_torch.ops import texture as _tex
from tpu_pathtracer_torch.ops.bvh import build_bvh, load_bvh_file


def staircase_materials(device="cpu"):
    """The 20-material staircase table, bit-for-bit from
    staircase_scene.h:140–160 (indexing = meshID, kernels.cu:455)."""
    return make_materials([
        dict(type=DIFFUSE, color=(0.01, 0.01, 0.01)),                    # Black
        dict(type=METAL, color=(0.27, 0.254, 0.15), param=0.01),         # Brass
        dict(type=METAL, color=(0, 0, 0), param=0.0, tex_id=8),          # BrushedAluminium
        dict(type=DIFFUSE, color=(1, 1, 1)),                             # Candles
        dict(type=DIFFUSE, color=(0.117647, 0.054902, 0.0666667)),       # ChairSeat
        dict(type=GLASS, color=(1, 1, 1), param=1.45),                   # Glass
        dict(type=METAL, color=(1.0, 0.95, 0.35), param=0.05),           # Gold
        dict(type=DIFFUSE, color=(0, 0, 0), tex_id=7),                   # Lampshade
        dict(type=DIFFUSE, color=(0.578596, 0.578596, 0.578596)),        # MagnoliaPaint
        dict(type=DIFFUSE, color=(0, 0, 0), tex_id=3),                   # Painting1
        dict(type=DIFFUSE, color=(0, 0, 0), tex_id=4),                   # Painting2
        dict(type=DIFFUSE, color=(0, 0, 0), tex_id=5),                   # Painting3
        dict(type=METAL, color=(1.0, 1.0, 1.0), param=0.1),              # StainlessSteel
        dict(type=DIFFUSE, color=(0, 0, 0), tex_id=1),                   # wallpaper
        dict(type=DIFFUSE, color=(0.578596, 0.578596, 0.578596)),        # whitePaint
        dict(type=DIFFUSE, color=(1, 1, 1)),                             # WhitePlastic
        dict(type=DIFFUSE, color=(0, 0, 0), tex_id=6),                   # WoodChair
        dict(type=DIFFUSE, color=(0, 0, 0), tex_id=0),                   # woodFloor
        dict(type=DIFFUSE, color=(0, 0, 0), tex_id=6),                   # WoodLamp
        dict(type=DIFFUSE, color=(0, 0, 0), tex_id=2),                   # woodstairs
    ], device=device)


STAIRCASE_TEXTURE_NAMES = [
    "WoodFloor.png", "Wallpaper.png", "Woodpanel.png", "Painting1.png",
    "Painting2.png", "Painting3.png", "WoodChair.png", "Fabric.png",
    "BrushedAluminium.png",
]  # staircase_scene.h:126–134


def _face(a, b, c, d, mesh_id: int, tris: list, sub: int) -> None:
    """Append a quad face as a sub×sub grid of triangle pairs (bilinear
    positions + uvs). sub=1 gives the two triangles with corner uvs
    (0,0),(1,0),(1,1),(0,1)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    c = np.asarray(c, np.float32)
    d = np.asarray(d, np.float32)
    t = np.linspace(0.0, 1.0, sub + 1, dtype=np.float32)
    uu = t[:, None, None]
    vv = t[None, :, None]
    # bilinear: corner order a=(0,0) b=(1,0) c=(1,1) d=(0,1)
    p = ((1 - uu) * (1 - vv) * a + uu * (1 - vv) * b
         + uu * vv * c + (1 - uu) * vv * d)            # [s+1, s+1, 3]
    uvg = np.stack(np.broadcast_arrays(uu[..., 0], vv[..., 0]),
                   axis=-1).astype(np.float32)          # [s+1, s+1, 2]

    p00, p10 = p[:-1, :-1].reshape(-1, 3), p[1:, :-1].reshape(-1, 3)
    p11, p01 = p[1:, 1:].reshape(-1, 3), p[:-1, 1:].reshape(-1, 3)
    u00, u10 = uvg[:-1, :-1].reshape(-1, 2), uvg[1:, :-1].reshape(-1, 2)
    u11, u01 = uvg[1:, 1:].reshape(-1, 2), uvg[:-1, 1:].reshape(-1, 2)
    # triangles (a,b,c) and (a,c,d) per cell
    v0 = np.concatenate([p00, p00])
    v1 = np.concatenate([p10, p11])
    v2 = np.concatenate([p11, p01])
    tc = np.concatenate(
        [np.concatenate([u00, u10, u11], axis=1),
         np.concatenate([u00, u11, u01], axis=1)])
    mid = np.full(v0.shape[0], mesh_id, np.int32)
    tris.append((v0, v1, v2, tc, mid))


def _box(center, size, mesh_id: int, tris: list, sub: int = 1) -> None:
    """Append the triangles of an axis-aligned box, each face a sub×sub
    grid (12 triangles at sub=1), with planar texcoords."""
    cx, cy, cz = center
    sx, sy, sz = size
    x0, x1 = cx - sx / 2, cx + sx / 2
    y0, y1 = cy - sy / 2, cy + sy / 2
    z0, z1 = cz - sz / 2, cz + sz / 2
    v = [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
         (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)]
    quads = [(0, 1, 2, 3), (5, 4, 7, 6), (4, 0, 3, 7),
             (1, 5, 6, 2), (3, 2, 6, 7), (4, 5, 1, 0)]
    for a, b, c, d in quads:
        _face(v[a], v[b], v[c], v[d], mesh_id, tris, sub)


def procedural_staircase_mesh(num_steps: int = 14,
                              prims_per_leaf: int = 5,
                              sub: int = 1):
    """Staircase-like geometry in the reference scene's coordinate frame
    (camera at y≈174 looking down -z, staircase_scene.h:63; light high at
    y≈716, kernels.cu:93). Returns (v0, v1, v2, texcoords, mesh_ids)
    numpy arrays. ``sub`` subdivides every face into a sub×sub grid: the
    same surfaces with sub² times the triangles."""
    tris: list = []
    # floor (woodFloor, meshID 17)
    _box((0.0, -5.0, 200.0), (800.0, 10.0, 900.0), 17, tris, sub)
    # back + side walls (wallpaper 13 / whitePaint 14)
    _box((0.0, 250.0, -260.0), (800.0, 520.0, 10.0), 13, tris, sub)
    _box((-400.0, 250.0, 200.0), (10.0, 520.0, 900.0), 14, tris, sub)
    _box((400.0, 250.0, 200.0), (10.0, 520.0, 900.0), 8, tris, sub)
    # stairs (woodstairs, meshID 19) climbing toward the back wall
    step_w, step_d, step_h = 180.0, 34.0, 18.0
    for i in range(num_steps):
        _box((-120.0, step_h / 2 + i * step_h, 120.0 - i * step_d),
             (step_w, step_h, step_d), 19, tris, sub)
    # banister posts (Brass, meshID 1)
    for i in range(0, num_steps, 2):
        _box((-120.0 + step_w / 2 + 6.0, i * step_h + 40.0,
              120.0 - i * step_d), (6.0, 80.0, 6.0), 1, tris, sub)
    # a chair-ish block (WoodChair 16) and a glass block (Glass 5)
    _box((140.0, 30.0, 260.0), (60.0, 60.0, 60.0), 16, tris, sub)
    _box((40.0, 40.0, 330.0), (40.0, 80.0, 40.0), 5, tris, sub)
    # paintings on the back wall (Painting1..3, meshIDs 9–11)
    for k in range(3):
        _box((-200.0 + 160.0 * k, 280.0, -252.0), (100.0, 130.0, 4.0),
             9 + k, tris, sub)
    # gold block (Gold 6) and steel block (StainlessSteel 12)
    _box((220.0, 25.0, 120.0), (50.0, 50.0, 50.0), 6, tris, sub)
    _box((-280.0, 35.0, 320.0), (70.0, 70.0, 70.0), 12, tris, sub)

    v0 = np.concatenate([t[0] for t in tris]).astype(np.float32)
    v1 = np.concatenate([t[1] for t in tris]).astype(np.float32)
    v2 = np.concatenate([t[2] for t in tris]).astype(np.float32)
    tc = np.concatenate([t[3] for t in tris]).astype(np.float32)
    mid = np.concatenate([t[4] for t in tris]).astype(np.int32)
    return v0, v1, v2, tc, mid


def procedural_textures() -> List[np.ndarray]:
    """Nine procedural stand-ins for the unshipped staircase PNGs."""
    palettes = [
        ((0.55, 0.36, 0.18), (0.42, 0.26, 0.12)),  # WoodFloor
        ((0.75, 0.71, 0.62), (0.66, 0.60, 0.52)),  # Wallpaper
        ((0.48, 0.31, 0.16), (0.38, 0.23, 0.11)),  # Woodpanel
        ((0.60, 0.20, 0.15), (0.85, 0.75, 0.55)),  # Painting1
        ((0.15, 0.30, 0.55), (0.80, 0.80, 0.70)),  # Painting2
        ((0.25, 0.45, 0.25), (0.90, 0.85, 0.60)),  # Painting3
        ((0.45, 0.28, 0.14), (0.35, 0.21, 0.10)),  # WoodChair
        ((0.55, 0.10, 0.12), (0.45, 0.08, 0.10)),  # Fabric
        ((0.70, 0.70, 0.72), (0.62, 0.62, 0.65)),  # BrushedAluminium
    ]
    return [_tex.checkerboard_texture(64, 8, c0, c1) for c0, c1 in palettes]


def procedural_staircase_scene(nx: int, ny: int, prims_per_leaf: int = 5,
                               num_steps: int = 14, sub: int = 1,
                               device="cpu"):
    """Self-contained staircase-style scene: mesh + BVH + textures + NEE
    light + const sky. Returns (scene, camera)."""
    v0, v1, v2, tc, mid = procedural_staircase_mesh(num_steps,
                                                    prims_per_leaf, sub)
    mesh = build_bvh(v0, v1, v2, tc, mid, prims_per_leaf=prims_per_leaf,
                     device=device)
    atlas, widths, heights = _tex.build_atlas(procedural_textures())
    scene = make_scene(
        staircase_materials(device), mesh=mesh,
        tex_atlas=atlas, tex_width=widths, tex_height=heights,
        use_nee=True, sky_mode=SKY_CONST)
    return scene, staircase_camera(nx, ny, device=device)


def load_staircase_scene(bvh_path: str, texture_dir: Optional[str],
                         nx: int, ny: int, device="cpu"):
    """Assemble the real staircase scene from a reference-format ``.bvh``
    plus the 9 texture PNGs (load_scene, staircase_scene.h:120–164).
    Returns (scene, camera)."""
    mesh = load_bvh_file(bvh_path, device=device)
    atlas = widths = heights = None
    if texture_dir is not None:
        images = [_tex.load_texture(os.path.join(texture_dir, name))
                  for name in STAIRCASE_TEXTURE_NAMES]
        atlas, widths, heights = _tex.build_atlas(images)
    scene = make_scene(
        staircase_materials(device), mesh=mesh,
        tex_atlas=atlas, tex_width=widths, tex_height=heights,
        use_nee=True, sky_mode=SKY_CONST)
    return scene, staircase_camera(nx, ny, device=device)
