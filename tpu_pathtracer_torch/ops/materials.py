"""Branchless masked BSDF scatter stage (counterpart of
``tpu_pathtracer/ops/materials.py``).

Every BSDF family's candidate direction and throughput is computed for
all lanes and the per-lane material type selects between them — the
JAX package's structure, expression for expression, so a path scatters
the same way in both. All seven families are here although the
random-spheres scene uses only DIFFUSE, METAL and GLASS.

Semantics (against the reference's material.h):
  * diffuse: wi = unit(n + random_in_unit_sphere).
  * glossy: fuzz perturbation only when fuzz > 1e-4.
  * fresnel layer: TIR-or-Schlick russian-roulette choice.
  * dielectric: Beer–Lambert ``exp(-σ·t)`` when exiting; refracted flips
    the path's inside state.
  * subsurface: free flight ``-log(u)/scatterDist``; the scattered
    direction is a non-normalized in-ball vector.
  * checker: 3-D sine parity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_pathtracer_torch.models import scene as sc
from tpu_pathtracer_torch.ops import rng as _rng
from tpu_pathtracer_torch.ops.v3 import V3, where as vwhere, reflect, refract


def schlick(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick Fresnel approximation. material.h:9–13."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


class ScatterOut(NamedTuple):
    """scatter_info (helper_structs.h:38–46), SoA."""
    wi: V3                    # next direction (may be non-unit for SSS)
    throughput: V3
    specular: torch.Tensor    # [N] bool
    refracted: torch.Tensor   # [N] bool
    t: torch.Tensor           # [N] distance travelled (SSS shortens)


def scatter(wo: V3, normal: V3, hit_t: torch.Tensor, hit_p: V3,
            inside: torch.Tensor, mtype: torch.Tensor, albedo: V3,
            color2: V3, param: torch.Tensor, param2: torch.Tensor,
            absorption: V3, scatter_dist: torch.Tensor,
            rng_base: torch.Tensor) -> ScatterOut:
    """One scatter for N lanes.

    Args:
      wo: incoming ray direction (unit).
      normal: shading normal, already flipped to face the ray.
      hit_t: intersection distance [N]; hit_p: hit point (the checker
        layer needs it).
      inside: per-path inside-the-model flag.
      mtype..albedo: gathered material columns; ``albedo`` is the
        texture-resolved color.
      rng_base: per-lane bounce draw-block base (rng.bounce_base).
    """
    u = lambda k: _rng.slot_uniform(rng_base, k)
    ones = V3.ones(hit_t.shape, hit_t.device)

    # Shared samples -------------------------------------------------------
    sph = _rng.in_unit_sphere_v3(u(_rng.S_BSDF0), u(_rng.S_BSDF1),
                                 u(_rng.S_BSDF2))
    diffuse_wi = (normal + sph).normalized()
    refl = reflect(wo, normal)

    def glossy_wi(fuzz):
        f = torch.where(fuzz > 1e-4, fuzz, 0.0)
        return (refl + sph * f).normalized()

    # Fresnel layer (material.h:55–60) -------------------------------------
    ior = torch.clamp_min(param, 1e-6)
    eta = torch.where(inside, ior, 1.0 / ior)
    cos_theta = torch.clamp_max((-wo).dot(normal), 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    reflect_choice = ((eta * sin_theta > 1.0)
                      | (u(_rng.S_BSDF3) < schlick(cos_theta, eta)))
    refract_wi = refract(wo, normal, eta).normalized()

    # Subsurface free flight (material.h:96–103) ---------------------------
    d_free = -torch.log(u(_rng.S_BSDF4)) / torch.clamp_min(scatter_dist,
                                                           1e-12)
    sss_scattered = inside & (d_free < hit_t)
    t_sss = torch.where(sss_scattered, d_free, hit_t)

    # Beer–Lambert when exiting (material.h:75–78, :102) --------------------
    absorb_glass = vwhere(inside, (absorption * (-hit_t)).exp(), ones)
    absorb_sss = vwhere(inside, (absorption * (-t_sss)).exp(), ones)

    # Checker (material.h:33–36) -------------------------------------------
    sines = (torch.sin(param * hit_p.x) * torch.sin(param * hit_p.y)
             * torch.sin(param * hit_p.z))
    checker_albedo = vwhere(sines < 0.0, albedo, color2)

    # Per-family candidates --------------------------------------------------
    glossy_main = glossy_wi(param)    # METAL: param is fuzz
    glossy_layer = glossy_wi(param2)  # layered BSDFs: param2 is fuzz
    glass_wi = vwhere(reflect_choice, glossy_layer, refract_wi)
    # GLASS passes the texture-resolved color as the glossy tint
    # (scene_materials.h:19); layered presets use color2 as their tint.
    glass_thr = absorb_glass * vwhere(reflect_choice, albedo, ones)
    coat_wi = vwhere(reflect_choice, glossy_layer, diffuse_wi)
    coat_thr = vwhere(reflect_choice, color2, albedo)
    sssd_wi = vwhere(sss_scattered, sph, glass_wi)
    sssd_thr = absorb_sss * vwhere(sss_scattered | ~reflect_choice, ones,
                                   color2)
    sss_wi = vwhere(sss_scattered, sph, wo)

    # Type dispatch (scene_materials.h:13–20 + preset families) -------------
    t_is = lambda k: mtype == k
    wi = diffuse_wi
    wi = vwhere(t_is(sc.METAL), glossy_main, wi)
    wi = vwhere(t_is(sc.GLASS), glass_wi, wi)
    wi = vwhere(t_is(sc.COAT), coat_wi, wi)
    wi = vwhere(t_is(sc.SSS_DIELECTRIC), sssd_wi, wi)
    wi = vwhere(t_is(sc.SSS), sss_wi, wi)

    thr = albedo  # DIFFUSE / METAL (tint = dispatch-resolved color)
    thr = vwhere(t_is(sc.GLASS), glass_thr, thr)
    thr = vwhere(t_is(sc.COAT), coat_thr, thr)
    thr = vwhere(t_is(sc.SSS_DIELECTRIC), sssd_thr, thr)
    thr = vwhere(t_is(sc.SSS), absorb_sss, thr)
    thr = vwhere(t_is(sc.CHECKER), checker_albedo, thr)

    specular = (t_is(sc.METAL) | t_is(sc.GLASS) | t_is(sc.SSS)
                | t_is(sc.SSS_DIELECTRIC) | (t_is(sc.COAT) & reflect_choice))

    refracted = ((t_is(sc.GLASS) & ~reflect_choice)
                 | (t_is(sc.SSS) & ~sss_scattered)
                 | (t_is(sc.SSS_DIELECTRIC) & ~sss_scattered
                    & ~reflect_choice))

    t_out = torch.where(t_is(sc.SSS) | t_is(sc.SSS_DIELECTRIC), t_sss, hit_t)

    return ScatterOut(wi=wi, throughput=thr, specular=specular,
                      refracted=refracted, t=t_out)
