"""terrain-big-668k's quant BVH4 tier against the heap on the card: the
port's counterpart of ``experiments/terrain_big_ab.py``.

    python -m tpu_pathtracer_torch.experiments.terrain_big_ab [ns]

terrain-big-668k (``terrain_big_zoo_scene``) at 512x512, ``ns`` spp
(default 4), depth 50, untextured, in three arms on one scene: its quant
BVH4 tables (K8/K9, the tier ``QUANT_AUTO_RATIO`` picks), ``bvh4=False``
(the heap, K5/K6) and the tables again; each warmed by 1 spp, then
timed twice in turns, the best of 2 kept. Prints the scene's build time
and its BVH4 tables (quant, nodes, KB, clusters, ``stack_cap``) first,
as the JAX script does. Needs a CUDA device; prints the card's
``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional, Tuple

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments.arms import Arm, Reading, run_arms
from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.models.shapes import terrain_big_zoo_scene

NS = 4
CONFIG = dict(nx=512, ny=512, max_depth=50, textures=False)
ARMS = {"bvh4q": {}, "heap": {"bvh4": False}, "bvh4q2": {}}
REPS = 2


def tables(scene) -> Optional[dict]:
    """The scene's BVH4 tables as the JAX script prints them, or None."""
    b4 = scene.mesh.bvh4
    if b4 is None:
        return None
    return dict(quant=b4.quant, nodes=b4.n_nodes,
                kb=(b4.bounds.numel() + b4.refs.numel()) * 4 >> 10,
                clusters=b4.n_clusters, stack_cap=b4.stack_cap)


def measure(device, ns: int = NS, config: dict = CONFIG,
            factory=terrain_big_zoo_scene, reps: int = REPS, **scene_kw
            ) -> Tuple[float, Optional[dict], Dict[str, Reading]]:
    """(the scene's build seconds, its ``tables``, the three arms' readings
    timed in turns)."""
    cfg = RenderConfig(ns=ns, **config)
    t0 = time.perf_counter()
    scene, cam = factory(cfg.nx, cfg.ny, device=device, **scene_kw)
    build = time.perf_counter() - t0
    out = run_arms([Arm(n, scene, cam, cfg.replace(**kw))
                    for n, kw in ARMS.items()], ns, reps=reps)
    return build, tables(scene), out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = card("terrain_big_ab")
    ns = int(argv[0]) if argv else NS
    build, b4, out = measure(dev, ns)
    print(f"build {build:.1f}s; bvh4 attached: {b4 is not None}", flush=True)
    if b4 is not None:
        print(f"  quant={b4['quant']} nodes={b4['nodes']} ({b4['kb']} KB) "
              f"clusters={b4['clusters']} stack_cap={b4['stack_cap']}",
              flush=True)
    for tag, r in out.items():
        print(f"  {tag:6s}: {r.seconds:.3f} s ({r.ms_per_spp:.1f} ms/spp) "
              f"mean={r.mean:.6f}; {r.line()}", flush=True)


if __name__ == "__main__":
    main()
