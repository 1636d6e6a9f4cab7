"""Profiling and throughput telemetry (counterpart of
``tpu_pathtracer/utils/profiling.py``).

The reference profiles externally with nvprof (Makefile:29–34) and counts
rays via atomic STATS counters (kernels.cu:48–67). Here:

  * :func:`trace` — context manager around ``torch.profiler`` writing a
    Chrome trace of the host and device activity of a block;
  * :func:`measure` — seconds and paths (and rays) a second of a warm
    render, timed by CUDA events on the card, using the plain engine's
    ``Stats`` counters for exact ray accounting.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the host and device activity of a block into a Chrome trace
    (``trace.json``) under ``log_dir``::

        with profiling.trace(out_dir):
            render_image(scene, cam, cfg)

    A ``torch.profiler`` session slows every later kernel launch of the
    process (on an NVIDIA H100 80GB HBM3, 700 W, a staircase-toy regen
    iteration ran ~25% slower after one session: PERF.md §6). So a trace
    runs after every timed frame of its process, never before or between
    them.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Measurement:
    def __init__(self, seconds: float, rays: Optional[int], paths: int):
        self.seconds = seconds
        self.rays = rays
        self.paths = paths

    @property
    def mrays_per_sec(self) -> Optional[float]:
        return None if self.rays is None else self.rays / self.seconds / 1e6

    @property
    def mpaths_per_sec(self) -> float:
        return self.paths / self.seconds / 1e6

    def __repr__(self):
        parts = [f"{self.seconds:.3f}s", f"{self.mpaths_per_sec:.1f} Mpaths/s"]
        if self.rays is not None:
            parts.append(f"{self.mrays_per_sec:.1f} Mrays/s")
        return "Measurement(" + ", ".join(parts) + ")"


def _timed(render: Callable, scene, camera, config) -> float:
    """Seconds of one render: CUDA events on the card (the render ends
    with a ``torch.cuda.synchronize()``), the host clock on the CPU."""
    if camera.device.type != "cuda":
        t0 = time.perf_counter()
        render(scene, camera, config)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(camera.device)
    start.record()
    render(scene, camera, config)
    end.record()
    torch.cuda.synchronize(camera.device)
    return start.elapsed_time(end) / 1e3


def measure(scene, camera, config, renderer: Optional[Callable] = None,
            count_rays: bool = False) -> Measurement:
    """Time a warm render; optionally run a stats pass for exact ray
    counts (primary + secondary + shadow — the reference's NUM_RAYS_*
    accounting, kernels.cu:116–137). The default renderer is the plain
    engine's ``render_image``."""
    from tpu_pathtracer_torch.engine.render import render_image

    render = renderer or render_image
    render(scene, camera, config)  # warm: builds the kernels
    seconds = _timed(render, scene, camera, config)

    rays = None
    if count_rays:
        scfg = config.replace(ns=min(config.ns, 4), stats=True)
        _, stats = render_image(scene, camera, scfg, report_stats=True)
        per_spp = (stats.primary + stats.secondary + stats.shadows) / scfg.ns
        rays = int(per_spp * config.ns)
    return Measurement(seconds, rays, config.num_pixels * config.ns)
