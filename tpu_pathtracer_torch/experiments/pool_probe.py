"""The regen lane pool's size on the card: the port's counterpart of
``experiments/pool_probe.py``.

    python -m tpu_pathtracer_torch.experiments.pool_probe [--dragon]

The knot (``knot_zoo_scene``, ~102k triangles; ``--dragon`` the 872k
dragon-class knot) at 512x512, depth 50, through the regen engine at the
lane pools 131,072, 196,608 and 262,144 (``rays_per_chunk``): each pool
warmed by 1 spp, then 8 spp from sample 1 timed, the pools in turns
(``arms.run_arms``). The port's default pool for these frames is 196,608
(``engine/regen.py`` ``_pool_size``, the TPU's carry budget). The pool
sets the number of regen iterations, and each iteration is one host sync,
so each line prints the iterations beside ms/spp. A pixel's samples are
keyed by (pixel, sample, bounce, slot), whatever lane renders them, so
every pool renders the same image. Needs a CUDA device; prints the
card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import sys
from typing import Dict

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments.arms import Arm, Reading, run_arms
from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene

POOLS = (131072, 196608, 262144)
DRAGON = dict(nu=1664, nv=262)
CONFIG = dict(nx=512, ny=512, ns=16, max_depth=50)
SPP, S0 = 8, 1  # the timed render: 8 spp from sample 1, after 1 spp at 0


def measure(device, pools=POOLS, spp: int = SPP, config: dict = CONFIG,
            factory=knot_zoo_scene, **scene_kw) -> Dict[str, Reading]:
    """The frame of ``factory(nx, ny, **scene_kw)`` under ``config`` at
    each pool of ``pools``, timed in turns. Returns each pool's reading,
    by "pool=<lanes>"."""
    cfg = RenderConfig(**config)
    scene, cam = factory(cfg.nx, cfg.ny, device=device, **scene_kw)
    return run_arms([Arm(f"pool={p}", scene, cam,
                         cfg.replace(rays_per_chunk=p)) for p in pools],
                    spp, s0=S0)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = card("pool_probe")
    kw = DRAGON if "--dragon" in argv else {}
    for name, r in measure(dev, **kw).items():
        # The JAX script prints the 8-spp sum's mean over 9
        # (experiments/pool_probe.py:34), not over 8; its figure comes
        # first, the mean a sample beside it.
        print(f"{name}: {r.ms_per_spp:7.1f} ms/spp (mean="
              f"{r.mean * r.spp / (r.spp + 1):.5f}; a sample {r.mean:.5f}); "
              f"{r.line()}", flush=True)


if __name__ == "__main__":
    main()
