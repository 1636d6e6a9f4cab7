"""CPU/NumPy oracle renderer (counterpart of ``tpu_pathtracer/oracle.py``).

An independent, deliberately simple second implementation of the exact
same physics (same RNG derivation, same BSDF/NEE/roulette semantics, same
accumulation rules — SURVEY §3.3), playing the role the reference's
brute-force no-BVH path plays (kernels.cu:307–321): a slow oracle the fast
path must match. Meshes are intersected by brute force.

The body is the JAX package's oracle line for line, so the two give the
same image bit for bit on the same scene. It takes the port's
``RenderConfig`` and ``Scene``, reads each scene and camera tensor to
NumPy once (``g`` in :func:`render_oracle`), and imports no kernel module
and nothing of ``torch.cuda``: it runs on the host beside a render on the
card, which is how ``chip_smoke.py`` gates the kernels' images against it.
"""

from __future__ import annotations

import numpy as np

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.models import scene as sc

FLT_MAX = np.float32(3.4028235e38)

# ----------------------------------------------------------------------------
# RNG (mirror of ops/rng.py)
# ----------------------------------------------------------------------------

U = np.uint32


def _pcg(x):
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        state = x * U(747796405) + U(2891336453)
        word = ((state >> ((state >> U(28)) + U(4))) ^ state) * U(277803737)
    return (word >> U(22)) ^ word


def _combine(a, b):
    with np.errstate(over="ignore"):
        b = np.asarray(b, np.uint32)
        a = a.astype(np.uint32)
        return _pcg(a ^ (b + U(0x9E3779B9) + (a << U(6)) + (a >> U(2))))


def _block(base, num_slots):
    with np.errstate(over="ignore"):
        slots = np.arange(num_slots, dtype=np.uint32)
        bits = _pcg(base[..., None] + slots * U(0x9E3779B9))
    return (bits >> U(8)).astype(np.float32) * np.float32(1.0 / 16777216.0)


def bounce_uniforms(pixel_id, sample, bounce, n=9):
    base = _combine(_combine(_pcg(pixel_id), sample), U(bounce) + U(0x85EBCA6B))
    return _block(base, n)


def camera_uniforms(pixel_id, sample):
    base = _combine(_combine(_pcg(pixel_id), sample), U(0x01000193))
    return _block(base, 4)


def in_unit_sphere(u1, u2, u3):
    z = 1.0 - 2.0 * u1
    phi = 2.0 * np.pi * u2
    s = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    r = np.cbrt(u3)
    return np.stack([r * s * np.cos(phi), r * s * np.sin(phi), r * z], -1)


def in_unit_disk(u1, u2):
    r = np.sqrt(u1)
    th = 2.0 * np.pi * u2
    return np.stack([r * np.cos(th), r * np.sin(th), np.zeros_like(r)], -1)


# ----------------------------------------------------------------------------
# math helpers
# ----------------------------------------------------------------------------


def dot(a, b):
    return np.sum(a * b, -1)


def unit(a):
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)


def reflect(v, n):
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, eta):
    cos_t = np.minimum(dot(-uv, n), 1.0)
    par = eta[..., None] * (uv + cos_t[..., None] * n)
    sq = dot(par, par)
    perp = np.where(sq >= 1.0, 0.0, -np.sqrt(np.maximum(1.0 - sq, 0.0)))
    return par + perp[..., None] * n


def schlick(c, eta):
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    return r0 + (1.0 - r0) * (1.0 - c) ** 5


# ----------------------------------------------------------------------------
# intersection
# ----------------------------------------------------------------------------


def hit_spheres(o, d, centers, radii, t_min, t_max):
    oc = o[:, None, :] - centers[None, :, :]
    b = dot(oc, d[:, None, :])
    c = dot(oc, oc) - radii[None, :] ** 2
    disc = b * b - c
    sq = np.sqrt(np.maximum(disc, 0.0))
    t1, t2 = -b - sq, -b + sq
    tmax = t_max[:, None] if np.ndim(t_max) else t_max
    ok = (disc > 0) & (radii > 0)[None, :]
    t1 = np.where(ok & (t1 > t_min) & (t1 < tmax), t1, FLT_MAX)
    t2 = np.where(ok & (t2 > t_min) & (t2 < tmax), t2, FLT_MAX)
    ts = np.minimum(t1, t2)
    idx = np.argmin(ts, -1)
    return ts[np.arange(len(o)), idx], idx.astype(np.int32)


def hit_sphere_one(o, d, center, radius, t_min, t_max):
    oc = o - center
    b = dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    sq = np.sqrt(np.maximum(disc, 0.0))
    t1, t2 = -b - sq, -b + sq
    t1 = np.where((disc > 0) & (t1 > t_min) & (t1 < t_max), t1, FLT_MAX)
    t2 = np.where((disc > 0) & (t2 > t_min) & (t2 < t_max), t2, FLT_MAX)
    return np.minimum(t1, t2)


def hit_plane(o, d, point, norm, t_min, t_max):
    denom = dot(norm, d)
    t = dot(point - o, norm) / denom
    return np.where((denom > -1e-6) | (t < t_min) | (t > t_max), FLT_MAX, t)


def hit_tris(o, d, v0, v1, v2, t_min, t_max):
    """Brute force all triangles, chunked. Returns (t, tri, u, v)."""
    n = len(o)
    best_t = np.broadcast_to(np.asarray(t_max, np.float32), (n,)).copy()
    best_i = np.full(n, -1, np.int32)
    best_u = np.zeros(n, np.float32)
    best_v = np.zeros(n, np.float32)
    for start in range(0, len(v0), 4096):
        a0 = v0[start:start + 4096][None]
        a1 = v1[start:start + 4096][None]
        a2 = v2[start:start + 4096][None]
        # sentinel padding triangles have +inf vertices (kernels.cu:202);
        # inf-inf = NaN is expected and masked by the `bad` test below, so
        # silence the (benign but alarming) RuntimeWarnings they raise.
        with np.errstate(invalid="ignore", over="ignore"):
            e1 = a1 - a0
            e2 = a2 - a0
            dd = d[:, None, :]
            oo = o[:, None, :]
            # classic two-cross Moller-Trumbore (intersections.h:54-83),
            # deliberately NOT the restructured determinant form the JAX
            # kernels use: the oracle is the independent correctness
            # anchor, so it must not share a potentially-buggy
            # reformulation with the code it checks (the rmse gates
            # absorb the fp-form difference)
            h = np.cross(dd, e2)
            a = dot(e1, h)
            par = np.abs(a) < 1e-7
            f = 1.0 / np.where(par, 1.0, a)
            s = oo - a0
            u = f * dot(s, h)
            q = np.cross(s, e1)
            v = f * dot(dd, q)
            t = f * dot(e2, q)
            bad = (par | (u < 0) | (u > 1) | (v < 0) | (u + v > 1)
                   | ~(t > t_min) | ~(t < best_t[:, None]) | ~np.isfinite(t))
        t = np.where(bad, FLT_MAX, t)
        j = np.argmin(t, -1)
        rows = np.arange(n)
        tj = t[rows, j]
        won = tj < best_t
        best_t = np.where(won, tj, best_t)
        best_i = np.where(won, start + j, best_i)
        best_u = np.where(won, u[rows, j], best_u)
        best_v = np.where(won, v[rows, j], best_v)
    return best_t, best_i, best_u, best_v


# ----------------------------------------------------------------------------
# renderer
# ----------------------------------------------------------------------------


def to_host(obj):
    """A scene or camera with every tensor read to a NumPy array: what
    :func:`render_oracle` takes in a host process of its own (the arrays
    pickle without the tensors' device or shared memory)."""
    return sc.map_tensors(obj, lambda t: t.detach().cpu().numpy())


def render_oracle(scene, camera, config: RenderConfig) -> np.ndarray:
    """Render [ny, nx, 3] linear radiance with plain NumPy."""
    seen = {}

    def g(x):
        """``x`` as a NumPy array, read from its device once a render."""
        if x is None:
            return None
        if id(x) not in seen:
            seen[id(x)] = (x, x.detach().cpu().numpy()
                           if hasattr(x, "detach") else np.asarray(x))
        return seen[id(x)][1]

    mats = scene.materials
    mesh = scene.mesh
    nx, ny = config.nx, config.ny
    n = nx * ny
    pixel = np.arange(n, dtype=np.uint32)

    cam_origin = g(camera.origin)
    cam_llc = g(camera.lower_left_corner)
    cam_h = g(camera.horizontal)
    cam_v = g(camera.vertical)
    cam_u = g(camera.u)
    cam_vv = g(camera.v)
    lens_r = float(g(camera.lens_radius))

    fb = np.zeros((n, 3), np.float32)

    for s in range(config.ns):
        us = camera_uniforms(pixel, U(s))
        i = (pixel % nx).astype(np.float32)
        j = (pixel // nx).astype(np.float32)
        su = (i + us[:, 0]) / nx
        tv = (j + us[:, 1]) / ny
        rd = lens_r * in_unit_disk(us[:, 2], us[:, 3])
        offset = rd[:, 0:1] * cam_u + rd[:, 1:2] * cam_vv
        origin = cam_origin + offset
        direction = unit(cam_llc + su[:, None] * cam_h + tv[:, None] * cam_v
                         - origin)

        color = np.zeros((n, 3), np.float32)
        att = np.ones((n, 3), np.float32)
        specular = np.zeros(n, bool)
        inside = np.zeros(n, bool)
        alive = np.ones(n, bool)

        for bounce in range(config.max_depth):
            if not alive.any():
                break
            ub = bounce_uniforms(pixel, U(s), bounce)

            # ---- intersect
            t = np.full(n, FLT_MAX, np.float32)
            obj = np.full(n, sc.OBJ_NONE, np.int32)
            normal = np.zeros((n, 3), np.float32)
            mat_id = np.zeros(n, np.int32)
            tex_u = np.zeros(n, np.float32)
            tex_v = np.zeros(n, np.float32)

            if mesh is not None:
                mt, mi, mu, mv = hit_tris(origin, direction, g(mesh.v0),
                                          g(mesh.v1), g(mesh.v2),
                                          config.epsilon, FLT_MAX)
                hitm = mi >= 0
                tri = np.maximum(mi, 0)
                v0 = g(mesh.v0)[tri]
                v1 = g(mesh.v1)[tri]
                v2 = g(mesh.v2)[tri]
                nrm = unit(np.cross(v1 - v0, v2 - v0))
                tc = g(mesh.tex_coords)[tri]
                w0 = 1.0 - mu - mv
                win = hitm & (mt < t)
                t = np.where(win, mt, t)
                obj = np.where(win, sc.OBJ_TRIMESH, obj)
                normal = np.where(win[:, None], nrm, normal)
                mat_id = np.where(win, g(mesh.mesh_id)[tri], mat_id)
                tex_u = np.where(win, mu * tc[:, 2] + mv * tc[:, 4] + w0 * tc[:, 0], tex_u)
                tex_v = np.where(win, mu * tc[:, 3] + mv * tc[:, 5] + w0 * tc[:, 1], tex_v)

            if scene.sphere_center is not None:
                st, si = hit_spheres(origin, direction, g(scene.sphere_center),
                                     g(scene.sphere_radius), config.epsilon, FLT_MAX)
                win = st < t
                p = origin + st[:, None] * direction
                nrm = ((p - g(scene.sphere_center)[si])
                       / g(scene.sphere_radius)[si][:, None])
                t = np.where(win, st, t)
                obj = np.where(win, sc.OBJ_SPHERE, obj)
                normal = np.where(win[:, None], nrm, normal)
                mat_id = np.where(win, g(scene.sphere_mat)[si], mat_id)

            if scene.plane_point is not None:
                pt = hit_plane(origin, direction, g(scene.plane_point),
                               g(scene.plane_norm), config.epsilon, FLT_MAX)
                win = pt < t
                t = np.where(win, pt, t)
                obj = np.where(win, sc.OBJ_PLANE, obj)
                normal = np.where(win[:, None], g(scene.plane_norm), normal)
                mat_id = np.where(win, int(g(scene.plane_mat)), mat_id)

            if scene.use_nee:
                lt = hit_sphere_one(origin, direction, g(scene.light_center),
                                    float(g(scene.light_radius)),
                                    config.epsilon, FLT_MAX)
                win = specular & (obj == sc.OBJ_NONE) & (lt < FLT_MAX)
                t = np.where(win, lt, t)
                obj = np.where(win, sc.OBJ_LIGHT, obj)

            flip = dot(direction, normal) > 0
            normal = np.where(flip[:, None], -normal, normal)

            # ---- miss → sky
            miss = alive & (obj == sc.OBJ_NONE)
            if scene.sky_mode == sc.SKY_GRADIENT:
                tt = 0.5 * (direction[:, 1] + 1.0)
                sky = ((1 - tt)[:, None] * np.array([1.0, 1, 1])
                       + tt[:, None] * np.array([0.5, 0.7, 1.0]))
            else:
                sky = np.broadcast_to(g(scene.sky_color), (n, 3))
            color += np.where(miss[:, None], att * sky, 0.0).astype(np.float32)

            light_hit = alive & (obj == sc.OBJ_LIGHT)
            if not config.shadow:
                color += np.where(light_hit[:, None],
                                  att * g(scene.light_color), 0.0)

            surf = alive & ~miss & ~light_hit
            alive = surf.copy()

            # ---- scatter
            mid = np.where(surf, mat_id, 0)
            mtype = g(mats.mtype)[mid]
            albedo = g(mats.color)[mid]
            if (scene.tex_atlas is not None and config.textures):
                tid = g(mats.tex_id)[mid]
                tid_c = np.maximum(tid, 0)
                w = g(scene.tex_width)[tid_c]
                h = g(scene.tex_height)[tid_c]
                fu = tex_u - np.floor(tex_u)
                fv = tex_v - np.floor(tex_v)
                tx = ((w - 1) * fu).astype(np.int32)
                ty = ((h - 1) * fv).astype(np.int32)
                texel = g(scene.tex_atlas)[tid_c, ty, tx]
                use = (obj == sc.OBJ_TRIMESH) & (tid >= 0)
                albedo = np.where(use[:, None], texel, albedo)
            color2 = g(mats.color2)[mid]
            param = g(mats.param)[mid]
            param2 = g(mats.param2)[mid]
            absorption = g(mats.absorption)[mid]
            sdist = g(mats.scatter_dist)[mid]

            hit_p = origin + t[:, None] * direction
            sph = in_unit_sphere(ub[:, 0], ub[:, 1], ub[:, 2])
            diffuse_wi = unit(normal + sph)
            refl = reflect(direction, normal)

            def glossy(fuzz):
                f = np.where(fuzz > 1e-4, fuzz, 0.0)
                return unit(refl + f[:, None] * sph)

            ior = np.maximum(param, 1e-6)
            eta = np.where(inside, ior, 1.0 / ior)
            cos_t = np.minimum(dot(-direction, normal), 1.0)
            sin_t = np.sqrt(np.maximum(1 - cos_t ** 2, 0.0))
            refl_choice = (eta * sin_t > 1.0) | (ub[:, 3] < schlick(cos_t, eta))
            refr_wi = unit(refract(direction, normal, eta))

            with np.errstate(divide="ignore"):
                d_free = -np.log(np.maximum(ub[:, 4], 0.0)) / np.maximum(sdist, 1e-12)
            sss_scat = inside & (d_free < t)
            t_sss = np.where(sss_scat, d_free, t)
            ones = np.ones((n, 3), np.float32)
            ab_glass = np.where(inside[:, None],
                                np.exp(-absorption * t[:, None]), ones)
            ab_sss = np.where(inside[:, None],
                              np.exp(-absorption * t_sss[:, None]), ones)
            sines = (np.sin(param * hit_p[:, 0]) * np.sin(param * hit_p[:, 1])
                     * np.sin(param * hit_p[:, 2]))
            checker_alb = np.where((sines < 0)[:, None], albedo, color2)

            glossy_m = glossy(param)
            glossy_l = glossy(param2)
            glass_wi = np.where(refl_choice[:, None], glossy_l, refr_wi)
            glass_thr = ab_glass * np.where(refl_choice[:, None], albedo, ones)
            coat_wi = np.where(refl_choice[:, None], glossy_l, diffuse_wi)
            coat_thr = np.where(refl_choice[:, None], color2, albedo)
            sssd_wi = np.where(sss_scat[:, None], sph, glass_wi)
            sssd_thr = ab_sss * np.where((sss_scat | ~refl_choice)[:, None],
                                         ones, color2)
            sss_wi = np.where(sss_scat[:, None], sph, direction)

            wi = diffuse_wi
            thr = albedo.copy()
            for k, wik, thrk in [
                (sc.METAL, glossy_m, albedo),
                (sc.GLASS, glass_wi, glass_thr),
                (sc.COAT, coat_wi, coat_thr),
                (sc.SSS_DIELECTRIC, sssd_wi, sssd_thr),
                (sc.SSS, sss_wi, ab_sss),
                (sc.CHECKER, diffuse_wi, checker_alb),
            ]:
                sel = mtype == k
                wi = np.where(sel[:, None], wik, wi)
                thr = np.where(sel[:, None], thrk, thr)

            spec_out = np.isin(mtype, [sc.METAL, sc.GLASS, sc.SSS,
                                       sc.SSS_DIELECTRIC]) \
                | ((mtype == sc.COAT) & refl_choice)
            refr_out = (((mtype == sc.GLASS) & ~refl_choice)
                        | ((mtype == sc.SSS) & ~sss_scat)
                        | ((mtype == sc.SSS_DIELECTRIC) & ~sss_scat & ~refl_choice))
            t_out = np.where(np.isin(mtype, [sc.SSS, sc.SSS_DIELECTRIC]), t_sss, t)

            origin = np.where(surf[:, None], origin + t_out[:, None] * direction,
                              origin)
            direction = np.where(surf[:, None], unit(wi), direction)
            att = np.where(surf[:, None], att * thr, att)
            specular = np.where(surf, spec_out, specular)
            inside = np.where(surf, inside ^ refr_out, inside)

            # ---- NEE
            if config.shadow and scene.use_nee:
                to_l = g(scene.light_center) - origin
                sw = unit(to_l)
                upv = np.where((np.abs(sw[:, 0]) > 0.01)[:, None],
                               np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
                su2 = unit(np.cross(upv, sw))
                sv2 = np.cross(sw, su2)
                d2 = dot(to_l, to_l)
                ratio = 1.0 - float(g(scene.light_radius)) ** 2 / d2
                valid = ratio >= 0
                cam_ = np.sqrt(np.maximum(ratio, 0))
                cosa = 1.0 - ub[:, 6] + ub[:, 6] * cam_
                sina = np.sqrt(np.maximum(1 - cosa ** 2, 0))
                phi = 2 * np.pi * ub[:, 7]
                l = (su2 * (np.cos(phi) * sina)[:, None]
                     + sv2 * (np.sin(phi) * sina)[:, None] + sw * cosa[:, None])
                dotl = dot(l, normal)
                mask = surf & ~specular & valid & (dotl > 0)
                sdir = unit(l)
                omega = 2 * np.pi * (1.0 - cam_)
                contrib = att * g(scene.light_color) * (dotl * omega / np.pi)[:, None]
                ldist = np.sqrt(d2) - float(g(scene.light_radius))
                occ = np.zeros(n, bool)
                tmax_s = np.where(mask, ldist, config.epsilon)
                if mesh is not None:
                    ot, oi, _, _ = hit_tris(origin, sdir, g(mesh.v0), g(mesh.v1),
                                            g(mesh.v2), config.epsilon, tmax_s)
                    occ |= oi >= 0
                if scene.sphere_center is not None:
                    ost, _ = hit_spheres(origin, sdir, g(scene.sphere_center),
                                         g(scene.sphere_radius),
                                         config.epsilon, tmax_s)
                    occ |= ost < tmax_s
                lit = mask & ~occ
                color += np.where(lit[:, None], contrib, 0.0).astype(np.float32)

            # ---- roulette
            if config.russian_roulette and bounce > config.rr_start_bounce:
                m = att.max(-1)
                rr = alive.copy()
                kill = rr & (ub[:, 8] > m)
                alive &= ~kill
                surv = rr & ~kill
                att = np.where(surv[:, None], att / np.maximum(m, 1e-30)[:, None],
                               att)

        fb += color

    return (fb / config.ns).reshape(ny, nx, 3)
