"""The knot's tier on the card, f32 BVH4 against the heap: the port's
counterpart of ``experiments/knot_tier_ab.py``.

    python -m tpu_pathtracer_torch.experiments.knot_tier_ab

knot-102k (``knot_zoo_scene``) at 512x512, 8 spp, depth 50, untextured,
in three arms: with its f32 BVH4 tables (K8/K9), the same scene with the
tables taken off (``bvh4=None``: the heap, K5/K6) and the tables again;
each warmed by 1 spp, then timed twice in turns (A, B, C, C, B, A), the
best of 2 kept. The JAX script's middle arm is "heap+pf1", the heap with
the TPU's next-leaf prefetch; the port's heap kernel has no prefetch and
keeps the label. All three compute one function: their means must agree
to 6 digits, as the JAX script asserts. Needs a CUDA device; prints the
card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments.arms import Arm, Reading, run_arms
from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene

CONFIG = dict(nx=512, ny=512, ns=8, max_depth=50, textures=False)
ARMS = ("bvh4", "heap+pf1", "bvh4_2")
REPS = 2


def measure(device, config: dict = CONFIG, reps: int = REPS,
            **scene_kw) -> Dict[str, Reading]:
    """The three arms, timed in turns; raises if the scene has no BVH4
    tables or the arms' means differ in the 6th digit."""
    cfg = RenderConfig(**config)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, device=device, **scene_kw)
    if scene.mesh.bvh4 is None:
        raise AssertionError("the knot has no BVH4 tables")
    heap = dataclasses.replace(
        scene, mesh=dataclasses.replace(scene.mesh, bvh4=None))
    out = run_arms([Arm(n, s, cam, cfg) for n, s in
                    zip(ARMS, (scene, heap, scene))], cfg.ns, reps=reps)
    means = {n: r.mean for n, r in out.items()}
    if len({round(m, 6) for m in means.values()}) != 1:
        raise AssertionError(f"knot_tier_ab: the arms' means differ: "
                             f"{means}")
    return out


def main(argv=None):
    dev = card("knot_tier_ab")
    for tag, r in measure(dev).items():
        print(f"  {tag:9s}: {r.seconds:.3f} s ({r.ms_per_spp:.1f} ms/spp) "
              f"mean={r.mean:.5f}; {r.line()}", flush=True)


if __name__ == "__main__":
    main()
