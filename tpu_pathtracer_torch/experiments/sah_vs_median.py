"""The BVH builder's split rule, native binned SAH against the NumPy median
split, end to end on the card: the port's counterpart of
``experiments/sah_vs_median.py``.

    python -m tpu_pathtracer_torch.experiments.sah_vs_median [spp]

knot-102k (``knot_zoo_scene``) at 512x512, ``spp`` (default 16), depth
50, untextured, a 65,536-lane pool, built twice: with the native builder
switched off ("median": the heap's median split, and the NumPy SAH
build under the BVH4 tables) and on ("sah"), through
``arms.builder``, which puts the native module back as it was. Each arm
is warmed by 1 spp, then timed, in turns. Prints the speedup and the
largest difference of the two images a sample. The knot carries f32
BVH4 tables with either builder, and the BVH4 tier comes first, so both
arms take that tier: the builder changes only the triangle order under
its clusters. Each line prints its tier and the scene's build time.
Needs a CUDA device; prints the card's ``nvidia-smi`` name and power
limit first.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, NamedTuple

import numpy as np

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments.arms import (Arm, Reading, builder,
                                                   run_arms)
from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene

SPP = 16
CONFIG = dict(nx=512, ny=512, max_depth=50, textures=False,
              rays_per_chunk=65536)
ARMS = {"median": False, "sah": True}  # the native builder on or off


class Result(NamedTuple):
    builds: Dict[str, float]    # each arm's scene build, seconds
    arms: Dict[str, Reading]
    speedup: float              # median's seconds over sah's
    max_diff: float             # max |median - sah| a sample


def measure(device, spp: int = SPP, config: dict = CONFIG,
            factory=knot_zoo_scene, **scene_kw) -> Result:
    """Both arms, each scene built under its builder, timed in turns."""
    cfg = RenderConfig(ns=spp, **config)
    arms, builds = [], {}
    for name, sah in ARMS.items():
        t0 = time.perf_counter()
        with builder(sah):
            scene, cam = factory(cfg.nx, cfg.ny, device=device, **scene_kw)
        builds[name] = time.perf_counter() - t0
        arms.append(Arm(name, scene, cam, cfg))
    out = run_arms(arms, spp)
    m, s = out["median"], out["sah"]
    return Result(builds, out, m.seconds / s.seconds,
                  float(np.abs(m.image - s.image).max()))


def report(res: Result) -> None:
    for name, r in res.arms.items():
        print(f"{name}: {r.seconds:.3f} s ({r.ms_per_spp:.0f} ms/spp) "
              f"mean={r.mean:.5f}; scene built in {res.builds[name]:.1f} "
              f"s; {r.line()}", flush=True)
    print(f"speedup sah vs median: {res.speedup:.3f}x", flush=True)
    print(f"max |median - sah| per-spp: {res.max_diff:.2e}", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = card("sah_vs_median")
    report(measure(dev, int(argv[0]) if argv else SPP))


if __name__ == "__main__":
    main()
