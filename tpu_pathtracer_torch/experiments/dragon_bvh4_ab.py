"""The dragon-class knot on the quant BVH4 tier against the heap on the
card: the port's counterpart of ``experiments/dragon_bvh4_ab.py``.

    python -m tpu_pathtracer_torch.experiments.dragon_bvh4_ab

The 872k-triangle knot (``knot_zoo_scene(nu=1664, nv=262)``) at 512x512,
4 spp, depth 50, untextured. By default it stays on the heap (the quant
tier's expected-cost gate); here ``attach_bvh4(mesh)`` is forced and
must come out quant. Two arms on that one scene: ``bvh4=False`` (the
heap, K5/K6) and ``bvh4=True`` (the quant BVH4 tables, K8/K9). Each is
warmed by a 4 spp render from sample 0, then 3 reps of 4 spp from sample
4 are timed in turns (the JAX script interleaves A, B, A, B; here A, B,
B, A, A, B). Prints the largest difference of the two arms' last sample
sums and the best ratio. A BVH4 stack overflow raises after the render
(``wavefront.check_traversal``). Needs a CUDA device; prints the card's
``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple

import numpy as np

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments.arms import Arm, Reading, run_arms
from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.ops.bvh4 import attach_bvh4

CONFIG = dict(nx=512, ny=512, ns=4, max_depth=50, textures=False)
DRAGON = dict(nu=1664, nv=262)
ARMS = {"heap": False, "bvh4q": True}  # the arms' config.bvh4
REPS, S0 = 3, 4  # warmed from sample 0, timed from sample 4


class Result(NamedTuple):
    build_s: float       # the scene's build
    attach_s: float      # the forced attach_bvh4
    tables: dict         # the quant tables: nodes, clusters, stack_cap
    arms: Dict[str, Reading]
    max_diff: float      # max |heap - bvh4q| of the last sample sums


def measure(device, config: dict = CONFIG, reps: int = REPS,
            quant="auto", **scene_kw) -> Result:
    """The two arms timed in turns; raises unless the forced tables are
    quant. ``scene_kw`` defaults to the dragon's; ``quant`` goes to
    ``attach_bvh4``."""
    cfg = RenderConfig(**config)
    t0 = time.perf_counter()
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, device=device,
                                **(scene_kw or DRAGON))
    t1 = time.perf_counter()
    mesh_q4 = attach_bvh4(scene.mesh, quant=quant)
    attach = time.perf_counter() - t1
    b4 = mesh_q4.bvh4
    if b4 is None or not b4.quant:
        raise AssertionError("expected the quant BVH4 tier")
    scene = dataclasses.replace(scene, mesh=mesh_q4)
    out = run_arms([Arm(n, scene, cam, cfg.replace(bvh4=b))
                    for n, b in ARMS.items()], cfg.ns, s0=S0, reps=reps,
                   warm_ns=cfg.ns)
    diff = float(np.abs(out["heap"].image - out["bvh4q"].image).max()
                 * cfg.ns)
    return Result(t1 - t0, attach,
                  dict(nodes=b4.n_nodes, clusters=b4.n_clusters,
                       stack_cap=b4.stack_cap), out, diff)


def main(argv=None):
    dev = card("dragon_bvh4_ab")
    res = measure(dev)
    t = res.tables
    print(f"scene built {res.build_s:.1f} s; bvh4 attached (quant, "
          f"{t['nodes']} nodes, {t['clusters']} clusters, stack_cap "
          f"{t['stack_cap']}) in {res.attach_s:.1f} s", flush=True)
    for name, r in res.arms.items():
        reps = ", ".join(f"{x:.3f}" for x in r.times)
        print(f"{name}: reps {reps} s (best {r.ms_per_spp:.1f} ms/spp) "
              f"mean={r.mean:.5f}; {r.line()}", flush=True)
    a, b = res.arms["heap"].ms_per_spp, res.arms["bvh4q"].ms_per_spp
    print(f"max |heap - bvh4q| (same samples) = {res.max_diff:.3e}",
          flush=True)
    print(f"BEST heap {a:.1f} ms/spp  bvh4q {b:.1f} ms/spp  "
          f"ratio {a / b:.3f}x", flush=True)


if __name__ == "__main__":
    main()
