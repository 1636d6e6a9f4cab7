"""Host-facing render API (counterpart of
``tpu_pathtracer/engine/render.py``): a one-shot :func:`render_image` and
a :class:`Renderer` with the reference's init / run / cleanup lifecycle.

Pixels are processed in fixed-size lane chunks and samples accumulate
in an inner loop, so arbitrarily large (resolution × spp) renders run
in bounded memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.camera import Camera
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.wavefront import Stats, trace
from tpu_pathtracer_torch.models.scene import Scene


def auto_chunk(config: RenderConfig) -> int:
    """Lane-chunk size: ``rays_per_chunk`` if set, else 128Ki lanes or the
    whole image if smaller."""
    if config.rays_per_chunk:
        return int(config.rays_per_chunk)
    return min(config.num_pixels, 1 << 17)


def sample_sum(scene: Scene, camera: Camera, config: RenderConfig,
               pixel_ids: torch.Tensor, ns: int, s0: int = 0,
               valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Stats]:
    """Sum of radiance over samples ``[s0, s0+ns)`` for a chunk of lanes;
    ``valid`` masks tail-padding duplicate lanes out of the Stats."""
    acc = torch.zeros((pixel_ids.shape[0], 3), device=pixel_ids.device)
    stats = Stats.zeros(pixel_ids.device)
    for s in range(ns):
        col, st = trace(scene, camera, config, pixel_ids, s0 + s,
                        valid=valid)
        acc = acc + col
        stats = stats.add(st)
    return acc, stats


def render_image(scene: Scene, camera: Camera, config: RenderConfig,
                 report_stats: bool = False):
    """Render the full frame with the plain engine. Returns ``[ny, nx, 3]``
    float32 linear mean radiance (row j=0 at the bottom). With
    ``report_stats=True`` returns (image, Stats of ints)."""
    dev = camera.device
    n = config.num_pixels
    chunk = auto_chunk(config)
    fb = np.zeros((n, 3), np.float32)
    stats_total = Stats.zeros(dev)
    for start in range(0, n, chunk):
        raw = torch.arange(start, start + chunk, device=dev)
        ids = raw.clamp(max=n - 1)  # tail padding
        valid = raw < n             # pads excluded from Stats
        acc, stats = sample_sum(scene, camera, config, ids, config.ns,
                                valid=valid)
        take = min(chunk, n - start)
        fb[start:start + take] = (acc / float(config.ns))[:take].cpu().numpy()
        stats_total = stats_total.add(stats)
    img = fb.reshape(config.ny, config.nx, 3)
    if report_stats:
        return img, stats_total.to_ints()
    return img


class Renderer:
    """Stateful facade over the init / run / cleanup lifecycle
    (kernels.cu:571–680)."""

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig):
        """initRenderer: the scene and camera already live on their
        device."""
        self.config = config
        self.camera = camera
        self.scene = scene
        self._fb: Optional[np.ndarray] = None
        self.stats: Optional[Stats] = None

    def run(self, ns: Optional[int] = None) -> np.ndarray:
        """runRenderer: trace ns samples/pixel and return the linear
        framebuffer [ny, nx, 3]."""
        cfg = self.config if ns is None else self.config.replace(ns=ns)
        self._fb, self.stats = render_image(self.scene, self.camera, cfg,
                                            report_stats=True)
        return self._fb

    @property
    def framebuffer(self) -> Optional[np.ndarray]:
        return self._fb

    def print_stats(self) -> None:
        """printStats — the reference's counter report
        (kernels.cu:116–137)."""
        if self.stats is None:
            return
        s = self.stats
        print("num rays:")
        rows = [("primary", s.primary),
                ("primary hit mesh", s.primary_hit_mesh),
                ("primary nohit", s.primary_nohit),
                ("primary bb nohit", s.primary_bbox_nohit),
                ("secondary", s.secondary),
                ("secondary no hit", s.secondary_nohit),
                ("secondary bb nohit", s.secondary_bbox_nohit),
                ("secondary mesh", s.secondary_mesh),
                ("secondary mesh nohit", s.secondary_mesh_nohit),
                ("shadows", s.shadows),
                ("shadows nohit", s.shadows_nohit),
                ("shadows bb nohit", s.shadows_bbox_nohit),
                ("power < 0.01", s.low_power),
                ("exceeded max bounce", s.exceed_max_bounce),
                ("russian roulette", s.roulette_kill),
                ("both nodes hit", s.nodes_both),
                ("single node hit", s.nodes_single),
                ("leaf visits (pkt)", s.leaf_visits),
                ("leaf pop-entered", s.leaf_pop)]
        for name, v in rows:
            print(f" {name:20s}: {v}")
        if int(s.nans) > 0:
            print(f"*** {s.nans} NaNs detected")

    def cleanup(self) -> None:
        """cleanupRenderer: drop the device references."""
        self.scene = None
        self._fb = None
