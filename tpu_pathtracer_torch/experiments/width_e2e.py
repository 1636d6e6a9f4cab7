"""Leaf width 32 against 64, each scene rebuilt at that width, end to end
on the card: the port's counterpart of ``experiments/width_e2e.py``.

    python -m tpu_pathtracer_torch.experiments.width_e2e [knot|stairs|dragon|terrain ...]

Each named workload (default knot, stairs and dragon) is built at
``prims_per_leaf`` = w and rendered with ``packet_width`` = w, for w in
32 and 64, with the engine's own pool (``rays_per_chunk=0``): each arm
warmed by 1 spp from sample 0, then ``ns`` spp from sample 1 timed, the
widths in turns. The workloads, as the JAX script has them: knot-131k
(512x512, depth 50, 8 spp timed), stairs-154k (the staircase at
``sub=20``, 1200x800, depth 64, 2 spp), dragon-872k (512x512, depth 50,
2 spp) and terrain-168k (512x512, depth 50, 4 spp). The BVH4 tables are
built at their own 64-triangle clusters whatever the heap's leaf width,
so a mesh on the BVH4 tier (the knot, the staircase at this size) runs
the same tier on the same clusters at both widths; each line prints its
tier. Needs a CUDA device; prints the card's ``nvidia-smi`` name and
power limit first.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, NamedTuple

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments.arms import Arm, run_arms
from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.models.shapes import (knot_zoo_scene,
                                                terrain_zoo_scene)


class Case(NamedTuple):
    label: str
    factory: Callable
    scene_kw: dict
    config: dict          # RenderConfig keywords
    ns: int               # the timed render's samples


WIDTHS = (32, 64)
DEFAULT = ("knot", "stairs", "dragon")
S0 = 1  # the timed render starts at sample 1, after 1 spp at 0
CASES = {
    "knot": Case("knot-131k", knot_zoo_scene, {},
                 dict(nx=512, ny=512, ns=16, max_depth=50,
                      rays_per_chunk=0), 8),
    "stairs": Case("stairs-154k", procedural_staircase_scene,
                   dict(sub=20), dict(nx=1200, ny=800, ns=4, max_depth=64,
                                      rays_per_chunk=0), 2),
    "dragon": Case("dragon-872k", knot_zoo_scene, dict(nu=1664, nv=262),
                   dict(nx=512, ny=512, ns=4, max_depth=50,
                        rays_per_chunk=0), 2),
    "terrain": Case("terrain-168k", terrain_zoo_scene, {},
                    dict(nx=512, ny=512, ns=8, max_depth=50,
                         rays_per_chunk=0), 4),
}


def measure(device, which=DEFAULT, widths=WIDTHS, cases: dict = CASES
            ) -> Dict[str, Dict[str, tuple]]:
    """{workload: {"w=<width>": (build seconds, reading)}}: each
    workload's widths, the scene rebuilt at each, timed in turns."""
    out = {}
    for name in which:
        case = cases[name]
        cfg = RenderConfig(**case.config)
        arms, builds = [], {}
        for w in widths:
            t0 = time.perf_counter()
            scene, cam = case.factory(cfg.nx, cfg.ny, prims_per_leaf=w,
                                      device=device, **case.scene_kw)
            builds[f"w={w}"] = time.perf_counter() - t0
            arms.append(Arm(f"w={w}", scene, cam,
                            cfg.replace(packet_width=w)))
        got = run_arms(arms, case.ns, s0=S0)
        out[name] = {k: (builds[k], r) for k, r in got.items()}
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = card("width_e2e")
    which = argv or DEFAULT
    for name, arms in measure(dev, which).items():
        for w, (build, r) in arms.items():
            # The JAX script prints the ns-spp sum's mean over ns + 1
            # (experiments/width_e2e.py:49); its figure first, the mean a
            # sample beside it.
            print(f"{CASES[name].label} {w}: {r.ms_per_spp:7.1f} ms/spp "
                  f"(build {build:.1f}s, mean="
                  f"{r.mean * r.spp / (r.spp + 1):.4f}; a sample "
                  f"{r.mean:.4f}); {r.line()}", flush=True)


if __name__ == "__main__":
    main()
