"""Wavefront renderer with pixel-stationary ray regeneration (counterpart
of ``tpu_pathtracer/engine/regen.py``).

A persistent pool of M lanes stays busy: lane ℓ owns pixels {ℓ, ℓ+M,
ℓ+2M, …} and traces all their samples back to back, starting the next
path the moment one ends. Each lane accumulates its own pixel's radiance
and writes it once, when the pixel's last sample ends, into slot
(round, lane) of a ``[rounds·M, 3]`` buffer that reshapes into the image.

The counter-based RNG is keyed by (pixel, sample, bounce), independent
of the lane schedule, so each path's radiance is bit-identical to the
plain engine's; only the per-pixel summation order can differ.

The loop checks ``done.all()`` on the host once per iteration: one
device sync an iteration (ROADMAP C-7). After it, the BVH4 kernels'
stack-overflow flag is read once (``check_traversal``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pathtracer_torch.camera import Camera
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.wavefront import (
    BounceState, Stats, _use_packet, bounce_step, check_traversal,
    initial_state, make_view)
from tpu_pathtracer_torch.models.scene import Scene
from tpu_pathtracer_torch.ops.v3 import V3, where as vwhere


def _pool_size(config: RenderConfig, num_pixels: int,
               scene: Scene | None = None) -> int:
    """Lane-pool size: ``rays_per_chunk`` if set; else the JAX package's
    choices: on its packet-BVH path 128k lanes with image textures and
    192k without, elsewhere 32768 (smaller pools cover more pixels per
    lane and average away the heavy-pixel tail). The pool sets the
    iteration count, and so the number of host syncs."""
    if config.rays_per_chunk:
        m = config.rays_per_chunk
    elif scene is not None and _use_packet(scene, config):
        textured = config.textures and scene.tex_atlas is not None
        m = (1 << 17) if textured else (3 << 16)
    else:
        m = 1 << 15
    return int(min(m, num_pixels))


def render_regen(scene: Scene, camera: Camera, config: RenderConfig,
                 ns=None, pixel_offset: int = 0,
                 num_pixels: int | None = None, s0: int = 0,
                 normalize: bool = True, return_iters: bool = False):
    """Render ``[num_pixels, 3]`` radiance with a pixel-stationary pool.

    ``pixel_offset``/``num_pixels`` select a contiguous pixel range;
    flat pixel ids stay global for RNG parity. ``ns`` overrides
    ``config.ns`` and ``s0`` offsets the sample indices (resume).
    ``normalize=False`` returns the radiance sum instead of the mean.
    Returns the framebuffer tensor, followed by the iteration count if
    ``return_iters`` and by the Stats if ``config.stats``.
    """
    dev = camera.device
    n = num_pixels if num_pixels is not None else config.num_pixels
    ns = int(config.ns if ns is None else ns)
    m = _pool_size(config, n, scene)
    rounds = (n + m - 1) // m
    view = make_view(scene, config)

    lane = torch.arange(m, device=dev)
    out = torch.zeros((rounds * m, 3), device=dev)  # slot r*M + lane
    zf = torch.zeros((m,), device=dev)
    zi = torch.zeros((m,), dtype=torch.int64, device=dev)
    zb = torch.zeros((m,), dtype=torch.bool, device=dev)
    # every lane starts reaped: the first iteration starts its first path
    state = initial_state(V3(zf, zf, zf), V3(zf, zf, zf + 1.0), zb)
    acc = V3(zf, zf, zf)
    cur_sample, rnd, bounce, done = zi, zi, zi, zb
    stats = Stats.zeros(dev) if config.stats else None
    iters = 0

    while not bool(done.all()):
        # ---- reap dead lanes: accumulate, maybe flush pixel, restart ----
        dead = ~state.alive & ~done
        if config.check_nans and config.stats:
            # per-path NaN count at reap time; each path is reaped once
            isnan = dead & (torch.isnan(state.color.x)
                            | torch.isnan(state.color.y)
                            | torch.isnan(state.color.z))
            stats = stats._replace(nans=stats.nans + isnan.sum())
        acc = vwhere(dead, acc + state.color, acc)
        color = vwhere(dead, 0.0, state.color)

        flush = dead & (cur_sample >= ns)  # pixel complete
        # In place, so the [rounds·M, 3] buffer is not copied every
        # iteration. Each (round, lane) slot is flushed exactly once, so
        # writing acc into it equals the JAX package's one-hot add into
        # zeros, bit for bit. Lanes not flushing write back the slot's
        # own value.
        slot = rnd.clamp(max=rounds - 1) * m + lane
        out[slot] = torch.where(flush[:, None], acc.stack(), out[slot])
        acc = vwhere(flush, 0.0, acc)
        rnd = torch.where(flush, rnd + 1, rnd)
        cur_sample = torch.where(flush, 0, cur_sample)
        done = done | (dead & ((rnd >= rounds) | (lane + rnd * m >= n)))

        # ---- start the next path on reaped, not-done lanes --------------
        start = dead & ~done
        pixel = pixel_offset + lane + rnd * m
        o2, d2 = camera.generate_rays(pixel, s0 + cur_sample,
                                      config.nx, config.ny)
        state = BounceState(
            origin=vwhere(start, o2, state.origin),
            direction=vwhere(start, d2, state.direction),
            color=color,
            attenuation=vwhere(start, 1.0, state.attenuation),
            specular=state.specular & ~start,
            inside=state.inside & ~start,
            alive=state.alive | start,
            from_mesh=state.from_mesh & ~start,
        )
        bounce = torch.where(start, 0, bounce)
        cur_sample = torch.where(start, cur_sample + 1, cur_sample)

        # ---- one wavefront bounce (of the sample started last) ----------
        state, new_stats = bounce_step(scene, view, config, state, pixel,
                                       s0 + cur_sample - 1, bounce, stats)
        if new_stats is not None:
            stats = new_stats
        bounce = bounce + 1
        if stats is not None:
            # lanes killed by the depth cap == plain engine's alive-at-end
            killed = state.alive & (bounce >= config.max_depth)
            stats = stats._replace(
                exceed_max_bounce=stats.exceed_max_bounce + killed.sum())
        state = state._replace(alive=state.alive
                               & (bounce < config.max_depth))
        iters += 1
    check_traversal(view)

    fb = out[:n]
    if normalize:
        fb = fb * (1.0 / ns)
    extras = []
    if return_iters:
        extras.append(iters)
    if stats is not None:
        extras.append(stats)
    return (fb, *extras) if extras else fb


def render_sample_range(scene: Scene, camera: Camera, config: RenderConfig,
                        s0: int, ns: int) -> np.ndarray:
    """Radiance SUM over samples [s0, s0+ns) for every pixel —
    [ny, nx, 3]. Sums over disjoint ranges add up to a straight run's
    sum."""
    fb = render_regen(scene, camera, config.replace(stats=False), ns=ns,
                      s0=s0, normalize=False)
    return fb.cpu().numpy().reshape(config.ny, config.nx, 3)


def render_image_regen(scene: Scene, camera: Camera, config: RenderConfig,
                       ns: int | None = None) -> np.ndarray:
    """Full-frame render via the regeneration engine; returns
    [ny, nx, 3] linear mean radiance. ``ns`` overrides ``config.ns``."""
    fb = render_regen(scene, camera, config.replace(stats=False), ns=ns)
    return fb.cpu().numpy().reshape(config.ny, config.nx, 3)
