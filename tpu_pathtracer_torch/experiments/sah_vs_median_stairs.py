"""Native binned SAH against the NumPy median split on the hires staircase,
end to end on the card: the port's counterpart of
``experiments/sah_vs_median_stairs.py``.

    python -m tpu_pathtracer_torch.experiments.sah_vs_median_stairs [spp]

The staircase at ``sub=20`` with 128-triangle leaves
(``procedural_staircase_scene(prims_per_leaf=128, sub=20)``) at
1200x800, ``spp`` (default 2), depth 64, a 65,536-lane pool, through
``sah_vs_median.measure``: the two builders' scenes, each warmed by 1
spp, then timed in turns; the speedup and the largest difference a
sample. The staircase carries BVH4 tables with either builder, built at
their own 64-triangle clusters, so both arms take the BVH4 tier. Needs a
CUDA device; prints the card's ``nvidia-smi`` name and power limit
first.
"""

from __future__ import annotations

import sys

from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.experiments.sah_vs_median import measure, report
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene

SPP = 2
CONFIG = dict(nx=1200, ny=800, max_depth=64, rays_per_chunk=65536)
SCENE = dict(prims_per_leaf=128, sub=20)


def measure_stairs(device, spp: int = SPP, config: dict = CONFIG,
                   scene_kw: dict = SCENE):
    """``sah_vs_median.measure`` on the staircase."""
    return measure(device, spp, config, procedural_staircase_scene,
                   **scene_kw)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = card("sah_vs_median_stairs")
    report(measure_stairs(dev, int(argv[0]) if argv else SPP))


if __name__ == "__main__":
    main()
