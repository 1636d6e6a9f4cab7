"""Analytic sphere scenes (counterpart of
``tpu_pathtracer/models/spheres.py``). The same numpy draws in the same
order give arrays identical to the JAX package's."""

from __future__ import annotations

import numpy as np

from tpu_pathtracer_torch.camera import make_camera
from tpu_pathtracer_torch.models.scene import (
    DIFFUSE, GLASS, METAL, SKY_GRADIENT, make_materials, make_scene)


def three_sphere_scene(nx: int, ny: int, device="cpu"):
    """Three diffuse spheres + ground — the CPU-golden scene of BASELINE
    config 1. Returns (scene, camera)."""
    mats = make_materials([
        dict(type=DIFFUSE, color=(0.5, 0.5, 0.5)),    # ground
        dict(type=DIFFUSE, color=(0.7, 0.2, 0.2)),
        dict(type=DIFFUSE, color=(0.2, 0.7, 0.2)),
        dict(type=DIFFUSE, color=(0.2, 0.2, 0.7)),
    ], device=device)
    centers = np.array([
        [0.0, -100.5, -1.0],
        [0.0, 0.0, -1.0],
        [-1.05, 0.0, -1.0],
        [1.05, 0.0, -1.0],
    ], np.float32)
    radii = np.array([100.0, 0.5, 0.5, 0.5], np.float32)
    mat_ids = np.array([0, 1, 2, 3], np.int32)
    scene = make_scene(mats, sphere_center=centers, sphere_radius=radii,
                       sphere_mat=mat_ids, use_nee=False,
                       sky_mode=SKY_GRADIENT)
    cam = make_camera((0.0, 0.3, 1.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0),
                      60.0, nx / ny, aperture=0.0, device=device)
    return scene, cam


def random_spheres_scene(nx: int, ny: int, seed: int = 1984,
                         device="cpu"):
    """The RTiOW final scene (486 spheres, all three material families) —
    BASELINE configs 2–3. Returns (scene, camera)."""
    rng = np.random.RandomState(seed)
    rows = [dict(type=DIFFUSE, color=(0.5, 0.5, 0.5))]  # ground
    centers = [[0.0, -1000.0, 0.0]]
    radii = [1000.0]

    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rng.rand()
            center = np.array([a + 0.9 * rng.rand(), 0.2, b + 0.9 * rng.rand()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.rand(3) * rng.rand(3)
                rows.append(dict(type=DIFFUSE, color=tuple(albedo)))
            elif choose < 0.95:
                albedo = 0.5 * (1.0 + rng.rand(3))
                fuzz = 0.5 * rng.rand()
                rows.append(dict(type=METAL, color=tuple(albedo), param=fuzz))
            else:
                rows.append(dict(type=GLASS, color=(1.0, 1.0, 1.0), param=1.5))
            centers.append(center.tolist())
            radii.append(0.2)

    rows.append(dict(type=GLASS, color=(1.0, 1.0, 1.0), param=1.5))
    centers.append([0.0, 1.0, 0.0])
    radii.append(1.0)
    rows.append(dict(type=DIFFUSE, color=(0.4, 0.2, 0.1)))
    centers.append([-4.0, 1.0, 0.0])
    radii.append(1.0)
    rows.append(dict(type=METAL, color=(0.7, 0.6, 0.5), param=0.0))
    centers.append([4.0, 1.0, 0.0])
    radii.append(1.0)

    mats = make_materials(rows, device=device)
    scene = make_scene(
        mats,
        sphere_center=np.asarray(centers, np.float32),
        sphere_radius=np.asarray(radii, np.float32),
        sphere_mat=np.arange(len(rows), dtype=np.int32),
        use_nee=False, sky_mode=SKY_GRADIENT)
    cam = make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                      20.0, nx / ny, aperture=0.1, focus_dist=10.0,
                      device=device)
    return scene, cam
