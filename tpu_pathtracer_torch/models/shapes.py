"""Procedural mesh shapes + the "model zoo" scene family (counterpart of
``tpu_pathtracer/models/shapes.py``). The numpy geometry is built exactly
as the JAX package builds it, so the arrays, the BVHs and the BVH4 tiers
are identical.

The reference benchmarked teapot / bunny / dragon meshes with four
material setups (coat, diffuse, glass, subsurface — TODO.txt model-zoo
tables, SURVEY §6). Those assets aren't shipped, so this module provides
procedural stand-ins at comparable triangle counts and the same scene
recipe: one model on a floor plane under the NEE sphere light.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tpu_pathtracer_torch.camera import Camera, make_camera
from tpu_pathtracer_torch.models import presets
from tpu_pathtracer_torch.models.scene import (SKY_CONST, Scene,
                                               make_materials, make_scene)
from tpu_pathtracer_torch.ops.bvh import build_bvh


def torus_mesh(nu: int = 96, nv: int = 64, big_r: float = 3.0,
               small_r: float = 1.2):
    """Torus triangle mesh with wrap-around UVs: 2·nu·nv triangles."""
    us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    x = (big_r + small_r * np.cos(vv)) * np.cos(uu)
    y = small_r * np.sin(vv) + small_r + 0.01
    z = (big_r + small_r * np.cos(vv)) * np.sin(uu)
    p = np.stack([x, y, z], -1).astype(np.float32)
    uvs = np.stack([uu / (2 * np.pi), vv / (2 * np.pi)], -1).astype(np.float32)

    v0, v1, v2, tc = [], [], [], []
    for i in range(nu):
        for j in range(nv):
            i2, j2 = (i + 1) % nu, (j + 1) % nv
            quad = [(i, j), (i2, j), (i2, j2), (i, j2)]
            for tri in ((0, 1, 2), (0, 2, 3)):
                v0.append(p[quad[tri[0]]])
                v1.append(p[quad[tri[1]]])
                v2.append(p[quad[tri[2]]])
                tc.append(np.concatenate([uvs[quad[k]] for k in tri]))
    return (np.asarray(v0, np.float32), np.asarray(v1, np.float32),
            np.asarray(v2, np.float32), np.asarray(tc, np.float32))


MODEL_ZOO_MATERIALS = {
    # the four model-zoo material setups (TODO.txt:293–298)
    "coat": presets.model_coat,
    "diffuse": presets.model_diffuse,
    "glass": presets.model_glass,
    "sss": presets.model_sss,
}


def model_zoo_scene(nx: int, ny: int, material: str = "coat",
                    nu: int = 96, nv: int = 64,
                    prims_per_leaf: int = 64,
                    device="cuda") -> Tuple[Scene, Camera]:
    """A ~12k-triangle torus (teapot-class) on a diffuse floor plane under
    the NEE sphere light — the reference's model-zoo benchmark recipe."""
    v0, v1, v2, tc = torus_mesh(nu, nv)
    mesh = build_bvh(v0, v1, v2, tc, np.ones((v0.shape[0],), np.int32),
                     prims_per_leaf=prims_per_leaf, device=device)
    mats = make_materials([presets.floor_diffuse(),
                           MODEL_ZOO_MATERIALS[material]()], device=device)
    scene = make_scene(
        mats, mesh=mesh,
        plane_point=(0.0, 0.0, 0.0), plane_norm=(0.0, 1.0, 0.0), plane_mat=0,
        light_center=(10.0, 25.0, 15.0), light_radius=4.0,
        light_color=(20.0, 20.0, 20.0),
        use_nee=True, sky_mode=SKY_CONST)
    cam = make_camera((9.0, 6.5, 9.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0),
                      40.0, nx / ny, device=device)
    return scene, cam


def torus_knot_mesh(nu: int = 512, nv: int = 100, p: int = 2, q: int = 3,
                    big_r: float = 3.0, mid_r: float = 1.1,
                    tube: float = 0.42):
    """(p,q) torus-knot tube mesh, fully vectorized: 2·nu·nv triangles.

    The dragon/bunny-class stand-in for the reference's model zoo
    (TODO.txt:283–298 benchmarks up to the 871k-triangle dragon): dense,
    curved, self-shadowing geometry at arbitrary triangle counts —
    nu=512,nv=100 → ~102k tris; nu=1664,nv=262 → ~872k tris.
    """
    t = np.linspace(0, 2 * np.pi, nu, endpoint=False)[:, None]
    # centerline on a torus + analytic tangent
    ct, st = np.cos(t), np.sin(t)
    cq, sq = np.cos(q * t), np.sin(q * t)
    w = big_r + mid_r * cq
    c = np.concatenate([w * np.cos(p * t), mid_r * sq,
                        w * np.sin(p * t)], axis=1)
    dw = -mid_r * q * sq
    dc = np.concatenate(
        [dw * np.cos(p * t) - w * p * np.sin(p * t),
         mid_r * q * cq,
         dw * np.sin(p * t) + w * p * np.cos(p * t)], axis=1)
    tan = dc / np.linalg.norm(dc, axis=1, keepdims=True)
    # stable frame: project a reference up-vector out of the tangent
    ref = np.broadcast_to(np.array([0.0, 1.0, 0.0]), tan.shape)
    n1 = ref - tan * (tan * ref).sum(1, keepdims=True)
    small = np.linalg.norm(n1, axis=1) < 1e-6
    alt = np.broadcast_to(np.array([1.0, 0.0, 0.0]), tan.shape)
    n1 = np.where(small[:, None],
                  alt - tan * (tan * alt).sum(1, keepdims=True), n1)
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 = np.cross(tan, n1)

    phi = np.linspace(0, 2 * np.pi, nv, endpoint=False)[None, :, None]
    ring = (n1[:, None, :] * np.cos(phi) + n2[:, None, :] * np.sin(phi))
    pts = (c[:, None, :] + tube * ring).astype(np.float32)  # [nu, nv, 3]
    pts[..., 1] += big_r + mid_r + tube + 0.01  # rest on the floor plane

    uu = np.broadcast_to(t / (2 * np.pi), (nu, nv))
    vv = np.broadcast_to(phi[0, :, 0] / (2 * np.pi), (nu, nv))
    uv = np.stack([uu, vv], axis=-1).astype(np.float32)  # [nu, nv, 2]

    # quad (i,j)-(i+1,j)-(i+1,j+1)-(i,j+1), both wraps, two tris per quad
    pr = np.roll(pts, -1, axis=0)   # i+1
    pd = np.roll(pts, -1, axis=1)   # j+1
    prd = np.roll(pr, -1, axis=1)   # i+1, j+1
    ur = np.roll(uv, -1, axis=0)
    ud = np.roll(uv, -1, axis=1)
    urd = np.roll(ur, -1, axis=1)

    def flat(a):
        return a.reshape(-1, a.shape[-1])

    v0 = np.concatenate([flat(pts), flat(pts)])
    v1 = np.concatenate([flat(pr), flat(prd)])
    v2 = np.concatenate([flat(prd), flat(pd)])
    tc = np.concatenate(
        [np.concatenate([flat(uv), flat(ur), flat(urd)], axis=1),
         np.concatenate([flat(uv), flat(urd), flat(ud)], axis=1)])
    return (np.ascontiguousarray(v0), np.ascontiguousarray(v1),
            np.ascontiguousarray(v2), np.ascontiguousarray(tc))


def terrain_mesh(n: int = 288, octaves: int = 6, struts: int = 600,
                 seed: int = 7, extent: float = 16.0):
    """Irregular, non-parametric test mesh: fBm-displaced terrain on a
    vertex-jittered grid plus a lattice of thin struts (VERDICT r2 item
    8 — real-world-topology stress: irregular tessellation + thin
    features, unlike the smooth parametric zoo tubes).

    - heightfield: ``octaves`` of bilinear value noise, amplitude 2^-o;
      grid xy positions jittered ±0.35 cells so triangle size/aspect
      varies continuously (no two triangles congruent).
    - struts: thin 3-sided prisms (radius ~0.02–0.05) between random
      nearby terrain points, the thin-feature half of the stress.

    Defaults give 2·(n−1)² + 6·struts ≈ 168k triangles.
    """
    rng = np.random.default_rng(seed)

    # --- fBm value noise on an n×n grid ------------------------------
    h = np.zeros((n, n))
    for o in range(octaves):
        k = 4 * (1 << o)  # lattice cells per side at this octave
        g = rng.standard_normal((k + 1, k + 1))
        # bilinear upsample to n×n
        t = np.linspace(0, k, n)
        i0 = np.minimum(t.astype(np.int64), k - 1)
        f = t - i0
        gx = g[i0] * (1 - f)[:, None] + g[i0 + 1] * f[:, None]
        gy = gx[:, i0] * (1 - f)[None, :] + gx[:, i0 + 1] * f[None, :]
        h += gy * (2.0 ** -o)
    h = (h - h.min()) * 1.8

    dx = extent / (n - 1)
    xs = np.linspace(-extent / 2, extent / 2, n)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gx = gx + rng.uniform(-0.35, 0.35, (n, n)) * dx
    gz = gz + rng.uniform(-0.35, 0.35, (n, n)) * dx
    pts = np.stack([gx, h + 0.05, gz], -1).astype(np.float32)
    uv = np.stack([(gx + extent / 2) / extent,
                   (gz + extent / 2) / extent], -1).astype(np.float32)

    p00, p10 = pts[:-1, :-1], pts[1:, :-1]
    p01, p11 = pts[:-1, 1:], pts[1:, 1:]
    u00, u10 = uv[:-1, :-1], uv[1:, :-1]
    u01, u11 = uv[:-1, 1:], uv[1:, 1:]

    def flat(a):
        return a.reshape(-1, a.shape[-1])

    v0 = np.concatenate([flat(p00), flat(p00)])
    v1 = np.concatenate([flat(p10), flat(p11)])
    v2 = np.concatenate([flat(p11), flat(p01)])
    tc = np.concatenate(
        [np.concatenate([flat(u00), flat(u10), flat(u11)], axis=1),
         np.concatenate([flat(u00), flat(u11), flat(u01)], axis=1)])

    # --- thin strut lattice ------------------------------------------
    if struts:
        ia = rng.integers(1, n - 1, (struts, 2))
        off = rng.integers(-24, 25, (struts, 2))
        ib = np.clip(ia + off, 1, n - 2)
        a = pts[ia[:, 0], ia[:, 1]].astype(np.float64)
        b = pts[ib[:, 0], ib[:, 1]].astype(np.float64)
        b[:, 1] += rng.uniform(0.5, 3.0, struts)  # struts lean upward
        axis = b - a
        ln = np.linalg.norm(axis, axis=1, keepdims=True)
        keep = ln[:, 0] > 0.3
        a, b, axis, ln = a[keep], b[keep], axis[keep], ln[keep]
        axis = axis / ln
        ref = np.where(np.abs(axis[:, 1:2]) < 0.9,
                       np.array([[0.0, 1.0, 0.0]]),
                       np.array([[1.0, 0.0, 0.0]]))
        s1 = np.cross(axis, ref)
        s1 /= np.linalg.norm(s1, axis=1, keepdims=True)
        s2 = np.cross(axis, s1)
        r = rng.uniform(0.02, 0.05, (a.shape[0], 1))
        sv0, sv1, sv2, suv = [], [], [], []
        for k in range(3):
            th0 = 2 * np.pi * k / 3
            th1 = 2 * np.pi * (k + 1) / 3
            e0 = s1 * np.cos(th0) + s2 * np.sin(th0)
            e1 = s1 * np.cos(th1) + s2 * np.sin(th1)
            a0, a1 = a + r * e0, a + r * e1
            b0, b1 = b + r * e0, b + r * e1
            sv0 += [a0, a0]
            sv1 += [b0, b1]
            sv2 += [b1, a1]
        m = a.shape[0] * 6
        v0 = np.concatenate([v0, np.concatenate(sv0)]).astype(np.float32)
        v1 = np.concatenate([v1, np.concatenate(sv1)]).astype(np.float32)
        v2 = np.concatenate([v2, np.concatenate(sv2)]).astype(np.float32)
        tc = np.concatenate([tc, np.zeros((m, 6), np.float32)])
    return (np.ascontiguousarray(v0), np.ascontiguousarray(v1),
            np.ascontiguousarray(v2), np.ascontiguousarray(tc, np.float32))


def terrain_zoo_scene(nx: int, ny: int, material: str = "diffuse",
                      n: int = 288, struts: int = 600,
                      prims_per_leaf: int = 64,
                      builder: str = "auto",
                      device="cuda") -> Tuple[Scene, Camera]:
    """Irregular-mesh zoo scene (~168k tris): noised terrain + thin strut
    lattice on a floor under the NEE light. Exists to re-check BVH
    builder conclusions (SAH vs median, leaf width) on non-parametric
    topology — the smooth zoo tubes may not transfer."""
    v0, v1, v2, tc = terrain_mesh(n=n, struts=struts)
    mesh = build_bvh(v0, v1, v2, tc, np.ones((v0.shape[0],), np.int32),
                     prims_per_leaf=prims_per_leaf, builder=builder,
                     device=device)
    mats = make_materials([presets.floor_diffuse(),
                           MODEL_ZOO_MATERIALS[material]()], device=device)
    scene = make_scene(
        mats, mesh=mesh,
        plane_point=(0.0, 0.0, 0.0), plane_norm=(0.0, 1.0, 0.0), plane_mat=0,
        light_center=(10.0, 30.0, 15.0), light_radius=4.0,
        light_color=(20.0, 20.0, 20.0),
        use_nee=True, sky_mode=SKY_CONST)
    cam = make_camera((14.0, 10.0, 14.0), (0.0, 2.0, 0.0), (0.0, 1.0, 0.0),
                      45.0, nx / ny, device=device)
    return scene, cam


def terrain_big_zoo_scene(nx: int, ny: int, material: str = "diffuse",
                          device="cuda") -> Tuple[Scene, Camera]:
    """Dragon-scale genuinely-irregular mesh (~668k real tris, 1M
    padded slots): the terrain generator at 4x density + 2x struts
    (VERDICT r3 item 8 — the 'dragon-class' knot is parametric/uniform
    and topology-friendly to the complete heap; this scene is not).

    Exercises the SAH BVH4 QUANT tier at dragon scale: the f32 node
    table exceeds SMEM_TABLE_BUDGET, and the per-mesh expected-cost
    tier selection (ops/bvh4.QUANT_AUTO_RATIO) attaches the
    uint16-quantized tables automatically (measured expected-cost
    ratio ~0.74-class topology, vs 0.95 for the knot/dragon which
    stay on the heap kernel's quantized-SMEM path)."""
    return terrain_zoo_scene(nx, ny, material=material, n=576,
                             struts=1200, device=device)


def _icosphere_faces(subdiv: int) -> np.ndarray:
    """Unit icosphere as independent faces [F, 3, 3] (midpoint
    subdivision, re-projected to the sphere each level). subdiv=3 →
    1280 faces, subdiv=4 → 5120."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])
    tri = verts[faces]  # [20, 3, 3]
    for _ in range(subdiv):
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        for m in (ab, bc, ca):
            m /= np.linalg.norm(m, axis=1, keepdims=True)
        tri = np.concatenate([
            np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
            np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1)])
    return tri


def _value_noise3(p: np.ndarray, rng, octaves: int = 3,
                  k0: int = 4) -> np.ndarray:
    """fBm trilinear value noise at points ``p`` in [-1,1]^3 — a pure
    function of position, so shared edges of independently-stored faces
    displace identically (no cracks)."""
    out = np.zeros(p.shape[0])
    amp = 1.0
    for o in range(octaves):
        k = k0 << o
        g = rng.standard_normal((k + 1, k + 1, k + 1))
        q = np.clip((p * 0.5 + 0.5), 0.0, 1.0) * k
        i = np.minimum(q.astype(np.int64), k - 1)
        f = q - i
        acc = np.zeros(p.shape[0])
        for dx in (0, 1):
            wx = f[:, 0] if dx else 1 - f[:, 0]
            for dy in (0, 1):
                wy = f[:, 1] if dy else 1 - f[:, 1]
                for dz in (0, 1):
                    wz = f[:, 2] if dz else 1 - f[:, 2]
                    acc += g[i[:, 0] + dx, i[:, 1] + dy,
                             i[:, 2] + dz] * wx * wy * wz
        out += acc * amp
        amp *= 0.5
    return out


def rock_pile_mesh(n_big: int = 140, n_small: int = 100, seed: int = 5,
                   spread: float = 4.5):
    """Genuinely irregular dragon-scale mesh (VERDICT r4 item 3): a
    mound of fBm-displaced, anisotropically-scaled, randomly-rotated
    icosphere "rocks" that deeply interpenetrate. Unlike the parametric
    knot (a smooth tube with near-ideal BVH locality) this has
    randomized triangle sizes (lognormal rock scales x per-axis
    stretch x noise displacement) and heavy bounding-box overlap
    (rocks bury into each other and the ground) — the BVH-hostile
    topology of a scanned model. Defaults: 140x5120 + 100x1280 =
    844,800 triangles."""
    rng = np.random.default_rng(seed)
    base = {3: _icosphere_faces(3), 4: _icosphere_faces(4)}
    v0s, v1s, v2s, tcs = [], [], [], []
    subdivs = [4] * n_big + [3] * n_small
    for subdiv in subdivs:
        tri = base[subdiv]  # [F, 3, 3] unit-sphere dirs
        fl = tri.reshape(-1, 3)
        # spherical uvs from the undisplaced direction
        u = np.arctan2(fl[:, 2], fl[:, 0]) / (2 * np.pi) + 0.5
        vv = np.arcsin(np.clip(fl[:, 1], -1, 1)) / np.pi + 0.5
        uv = np.stack([u, vv], -1)
        # bumpy radial displacement, per-rock noise field
        r = 1.0 + 0.45 * _value_noise3(fl, rng)
        pts = fl * r[:, None]
        # anisotropic stretch + random rotation + lognormal scale
        s = np.exp(rng.normal(0.0, 0.55))
        s = float(np.clip(s, 0.35, 3.2))
        pts = pts * (s * rng.uniform(0.6, 1.4, (1, 3)))
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        pts = pts @ q.T
        # mound placement: gaussian cluster, partially buried
        cx, cz = rng.normal(0.0, spread, 2)
        cy = abs(rng.normal(0.0, 1.8)) + 0.35 * s
        pts += np.array([cx, cy, cz])
        pts = pts.reshape(-1, 3, 3)
        uv = uv.reshape(-1, 3, 2)
        v0s.append(pts[:, 0])
        v1s.append(pts[:, 1])
        v2s.append(pts[:, 2])
        tcs.append(uv.reshape(-1, 6))
    return (np.concatenate(v0s).astype(np.float32),
            np.concatenate(v1s).astype(np.float32),
            np.concatenate(v2s).astype(np.float32),
            np.concatenate(tcs).astype(np.float32))


def rocks_zoo_scene(nx: int, ny: int, material: str = "diffuse",
                    n_big: int = 140, n_small: int = 100, seed: int = 5,
                    prims_per_leaf: int = 64,
                    builder: str = "auto",
                    device="cuda") -> Tuple[Scene, Camera]:
    """Irregular dragon-scale zoo scene (~845k tris): the rock pile on
    a floor plane under the NEE light. The honest counterpart to the
    'dragon-class' knot row (same triangle count, hostile topology) —
    reference anchor: the model-zoo dragon, TODO.txt:283-298."""
    v0, v1, v2, tc = rock_pile_mesh(n_big=n_big, n_small=n_small,
                                    seed=seed)
    mesh = build_bvh(v0, v1, v2, tc, np.ones((v0.shape[0],), np.int32),
                     prims_per_leaf=prims_per_leaf, builder=builder,
                     device=device)
    mats = make_materials([presets.floor_diffuse(),
                           MODEL_ZOO_MATERIALS[material]()], device=device)
    scene = make_scene(
        mats, mesh=mesh,
        plane_point=(0.0, 0.0, 0.0), plane_norm=(0.0, 1.0, 0.0), plane_mat=0,
        light_center=(12.0, 28.0, 15.0), light_radius=4.0,
        light_color=(20.0, 20.0, 20.0),
        use_nee=True, sky_mode=SKY_CONST)
    cam = make_camera((16.0, 9.0, 16.0), (0.0, 2.0, 0.0), (0.0, 1.0, 0.0),
                      45.0, nx / ny, device=device)
    return scene, cam


def knot_zoo_scene(nx: int, ny: int, material: str = "coat",
                   nu: int = 512, nv: int = 100,
                   prims_per_leaf: int = 64,
                   device="cuda") -> Tuple[Scene, Camera]:
    """Large-mesh model-zoo scene: a torus-knot tube (default ~102k tris,
    dragon-class at nu=1664, nv=262) on a diffuse floor under the NEE
    light — the workload for the packet-BVH TPU path. ``prims_per_leaf``
    defaults to 32-triangle clusters (width sweep: finer leaf culling
    shrinks the visit union; PERFORMANCE.md).

    Builder is the SAH default: at 128-wide clusters the median order's
    contiguous tube runs won (0.585 vs 0.70 s/spp), but at width 32 the
    preference flips — SAH 280 vs median 307 ms/spp — because narrow
    leaves make tree quality dominate over leaf-run contiguity.
    """
    v0, v1, v2, tc = torus_knot_mesh(nu, nv)
    mesh = build_bvh(v0, v1, v2, tc, np.ones((v0.shape[0],), np.int32),
                     prims_per_leaf=prims_per_leaf, device=device)
    mats = make_materials([presets.floor_diffuse(),
                           MODEL_ZOO_MATERIALS[material]()], device=device)
    scene = make_scene(
        mats, mesh=mesh,
        plane_point=(0.0, 0.0, 0.0), plane_norm=(0.0, 1.0, 0.0), plane_mat=0,
        light_center=(10.0, 25.0, 15.0), light_radius=4.0,
        light_color=(20.0, 20.0, 20.0),
        use_nee=True, sky_mode=SKY_CONST)
    cam = make_camera((11.0, 8.0, 11.0), (0.0, 4.5, 0.0), (0.0, 1.0, 0.0),
                      42.0, nx / ny, device=device)
    return scene, cam
