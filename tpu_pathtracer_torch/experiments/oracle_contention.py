"""Do the NumPy oracle's host processes slow a host-bound frame beside
them? ``chip_smoke.py`` renders the four oracle gates' oracles in host
processes (niced, one a gate) beside its timed frames; this measures what
that costs those frames.

    python -m tpu_pathtracer_torch.experiments.oracle_contention [rounds]

In ``rounds`` rounds (default 4), alternating which side runs first, it
times the headline (1200x800, 10 spp, depth 50, ``render_image_regen``)
and one spp of BASELINE config 5's 4K frame (3840x2160, depth 64,
``render_sample_range``) alone, and beside four niced ``spawn``
processes each rendering the rocks gate's oracle
(``rocks_zoo_scene(64, 48, n_big=2, n_small=3, seed=9)``, 4 spp, depth 8,
``packet_threshold=1``, as ``bench.py:280-285``), started 15 s before the
frames so that they are past their imports. Times are the host clock
around each render, closed by ``torch.cuda.synchronize()``; it prints
every reading and each side's median. Needs a CUDA device; prints the
card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import multiprocessing
import os
import statistics
import sys
import time

import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.regen import (render_image_regen,
                                               render_sample_range)
from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.models.shapes import rocks_zoo_scene
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.oracle import render_oracle, to_host

PROCESSES = 4
START_S = 15.0  # a spawned process's imports take a few seconds
ROCKS_GATE = dict(nx=64, ny=48, ns=4, max_depth=8, textures=False,
                  packet_threshold=1)


def _oracle(scene, cam, cfg):
    render_oracle(scene, cam, cfg)


def _frames(dev):
    h = RenderConfig(nx=1200, ny=800, ns=10, max_depth=50)
    hs, hc = random_spheres_scene(h.nx, h.ny, device=dev)
    c5 = RenderConfig(nx=3840, ny=2160, ns=1, max_depth=64)
    ss, sc = procedural_staircase_scene(c5.nx, c5.ny, device=dev)
    return {"headline 10 spp": lambda: render_image_regen(hs, hc, h),
            "config 5, 1 spp at 4K":
                lambda: render_sample_range(ss, sc, c5, 0, 1)}


def measure(dev, rounds: int = 4) -> dict:
    """{(frame, "alone" or "beside"): [seconds a round]}."""
    frames = _frames(dev)
    for fn in frames.values():
        fn()  # warm: builds the kernels
    cfg = RenderConfig(**ROCKS_GATE)
    scene, cam = rocks_zoo_scene(cfg.nx, cfg.ny, n_big=2, n_small=3,
                                 seed=9, device=dev)
    job = (to_host(scene), to_host(cam), cfg)
    out = {(k, side): [] for k in frames for side in ("alone", "beside")}
    for r in range(rounds):
        for side in (("alone", "beside") if r % 2 == 0
                     else ("beside", "alone")):
            pool = None
            try:
                if side == "beside":
                    pool = multiprocessing.get_context("spawn").Pool(
                        PROCESSES, initializer=os.nice, initargs=(10,))
                    jobs = [pool.apply_async(_oracle, job)
                            for _ in range(PROCESSES)]
                    time.sleep(START_S)
                    for j in jobs:
                        if j.ready():  # raises the oracle's error, if any
                            j.get()
                            raise RuntimeError("an oracle process ended "
                                               "before the frames ran")
                for k, fn in frames.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    out[k, side].append(time.perf_counter() - t0)
            finally:
                if pool is not None:
                    pool.terminate()
                    pool.join()
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = card("oracle_contention")
    rounds = int(argv[0]) if argv else 4
    res = measure(dev, rounds)
    for (k, side), v in res.items():
        print(f"{k} {side}: median {statistics.median(v):.3f} s, rounds "
              f"{', '.join(f'{x:.3f}' for x in v)}", flush=True)


if __name__ == "__main__":
    main()
