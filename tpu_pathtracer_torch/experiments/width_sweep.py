"""Leaf-cluster width sweep on the card: the port's counterpart of
``experiments/width_sweep.py``.

    python -m tpu_pathtracer_torch.experiments.width_sweep [--knot|--dragon] [--exact] [spp] [width ...]

One workload, rebuilt at ``prims_per_leaf`` = ``packet_width`` = w for
each width (default 128, 64, 32), at 2 spp (default) and a 65,536-lane
pool: the staircase at ``sub=20`` (1200x800, depth 64; the default),
knot-102k (``--knot``) or the dragon-class knot (``--dragon``; both
512x512, depth 50, untextured). ``mx_leaf`` is on unless ``--exact``.
Each width is warmed by 1 spp, then timed, the widths in turns. The
staircase and the knot carry BVH4 tables at their own 64-triangle
clusters at every width, and the BVH4 tier comes before ``mx_leaf``, so
there neither the width nor ``--exact`` changes the kernels; only the
dragon sees both, and at 128 a leaf its heap passes the quant BVH4
tier's cost gate, so that arm takes the quant BVH4 tier. Each line
prints the tier. Needs a CUDA device; prints the card's ``nvidia-smi``
name and power limit first.
"""

from __future__ import annotations

import sys
from typing import Dict

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments.arms import Arm, Reading, run_arms
from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene

SPP = 2
WIDTHS = (128, 64, 32)
KNOT_CONFIG = dict(nx=512, ny=512, max_depth=50, textures=False,
                   rays_per_chunk=65536)
STAIRS_CONFIG = dict(nx=1200, ny=800, max_depth=64, rays_per_chunk=65536)
CASES = {  # (factory, RenderConfig keywords, scene keywords)
    "knot": (knot_zoo_scene, KNOT_CONFIG, {}),
    "dragon": (knot_zoo_scene, KNOT_CONFIG, {"nu": 1664, "nv": 262}),
    "stairs": (procedural_staircase_scene, STAIRS_CONFIG, {"sub": 20}),
}


def measure(device, kind: str = "stairs", spp: int = SPP, widths=WIDTHS,
            mx: bool = True, cases: dict = CASES) -> Dict[str, Reading]:
    """{"width=<w>": reading} of one workload, timed in turns."""
    factory, config, skw = cases[kind]
    arms = []
    for w in widths:
        cfg = RenderConfig(ns=spp, packet_width=w, mx_leaf=mx, **config)
        scene, cam = factory(cfg.nx, cfg.ny, prims_per_leaf=w,
                             device=device, **skw)
        arms.append(Arm(f"width={w}", scene, cam, cfg))
    return run_arms(arms, spp)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = card("width_sweep")
    kind, mx = "stairs", True
    while argv and argv[0].startswith("--"):
        if argv[0] in ("--knot", "--dragon"):
            kind = argv[0][2:]
        elif argv[0] == "--exact":
            mx = False
        argv = argv[1:]
    spp = int(argv[0]) if argv else SPP
    widths = [int(w) for w in argv[1:]] or list(WIDTHS)
    for r in measure(dev, kind, spp, widths, mx).values():
        w = int(r.name.split("=")[1])
        print(f"{kind} width={w:4d}: {r.seconds:7.3f} s "
              f"({r.ms_per_spp:5.0f} ms/spp) mean={r.mean:.6f}; "
              f"{r.line()}", flush=True)


if __name__ == "__main__":
    main()
