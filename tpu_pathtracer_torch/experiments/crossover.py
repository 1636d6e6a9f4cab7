"""Where the brute-force triangle kernel and the BVH tiers cross on the
card: the port's counterpart of ``experiments/crossover.py``.

    python -m tpu_pathtracer_torch.experiments.crossover [spp]

The 12,288-triangle model-zoo torus (``model_zoo_scene(nu=96, nv=64,
prims_per_leaf=32)``: 16,384 heap slots, exactly ``TRI_BRUTE_MAX``) at
512x512, depth 50, untextured, a 65,536-lane pool, 16 spp, in two arms
on one mesh: ``packet_threshold=0`` (which resolves to ``TRI_BRUTE_MAX``:
16,384 > 16,384 is false, so the brute kernels K4/K4c) and
``packet_threshold=1`` (the packet path). The mesh carries f32 BVH4
tables in both packages, so the second arm takes the BVH4 tier (K8/K9),
not the heap the JAX script's label "packet-32" names: each line is
labelled by the tier its arm took. Both arms compute one function; the
images agree up to ties and ulps (``chip_smoke.py`` phase 22 bounds
them). Each arm is warmed by 1 spp, then timed, in turns. Needs a CUDA
device; prints the card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import sys
from typing import Dict

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments.arms import Arm, Reading, run_arms
from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.models.shapes import model_zoo_scene

SPP = 16
SCENE = dict(nu=96, nv=64, prims_per_leaf=32)  # 12,288 real triangles
CONFIG = dict(nx=512, ny=512, max_depth=50, textures=False,
              rays_per_chunk=65536)
THRESHOLDS = {"brute": 0, "packet": 1}  # the arms' packet_threshold


def measure(device, spp: int = SPP, config: dict = CONFIG,
            scene_kw: dict = SCENE) -> Dict[str, Reading]:
    """The two arms on one mesh, timed in turns: "brute" and "packet"."""
    cfg = RenderConfig(ns=spp, **config)
    scene, cam = model_zoo_scene(cfg.nx, cfg.ny, device=device, **scene_kw)
    return run_arms([Arm(name, scene, cam, cfg.replace(packet_threshold=t))
                     for name, t in THRESHOLDS.items()], spp)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = card("crossover")
    spp = int(argv[0]) if argv else SPP
    for r in measure(dev, spp).values():
        print(f"zoo-12k {r.tier:10s}: {r.seconds:7.3f} s "
              f"({r.ms_per_spp:5.0f} ms/spp) mean={r.mean:.6f}; {r.line()}",
              flush=True)


if __name__ == "__main__":
    main()
