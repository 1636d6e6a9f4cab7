"""The model-zoo material table on the card: the port's counterpart of
``experiments/zoo_table.py``.

    python -m tpu_pathtracer_torch.experiments.zoo_table [spp]

The model-zoo torus (``model_zoo_scene(nu=96, nv=64)``, ~12k triangles)
in each of its four materials, coat, diffuse, glass and sss, at 512x512,
``spp`` (default 64), depth 50, untextured: each warmed by 1 spp, then
timed, the materials in turns. Each line prints its tier. Needs a CUDA
device; prints the card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import sys
from typing import Dict

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments.arms import Arm, Reading, run_arms
from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.models.shapes import model_zoo_scene

SPP = 64
MATERIALS = ("coat", "diffuse", "glass", "sss")
CONFIG = dict(nx=512, ny=512, max_depth=50, textures=False)
SCENE = dict(nu=96, nv=64)


def measure(device, spp: int = SPP, materials=MATERIALS,
            config: dict = CONFIG, scene_kw: dict = SCENE
            ) -> Dict[str, Reading]:
    """{material: reading}, timed in turns."""
    cfg = RenderConfig(ns=spp, **config)
    arms = []
    for mat in materials:
        scene, cam = model_zoo_scene(cfg.nx, cfg.ny, material=mat,
                                     device=device, **scene_kw)
        arms.append(Arm(mat, scene, cam, cfg))
    return run_arms(arms, spp)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = card("zoo_table")
    spp = int(argv[0]) if argv else SPP
    for mat, r in measure(dev, spp).items():
        print(f"zoo-{mat:7s} {r.cfg.nx}x{r.cfg.ny}@{spp}spp:"
              f" {r.seconds:7.2f} s mean={r.mean:.5f}; {r.line()}",
              flush=True)


if __name__ == "__main__":
    main()
