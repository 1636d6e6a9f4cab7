"""``packet_width`` 64 against 128 on the knot and the dragon, end to end on
the card: the port's counterpart of ``experiments/width_e2e_ab.py``.

    python -m tpu_pathtracer_torch.experiments.width_e2e_ab [spp] [--dragon-only|--knot-only]

knot-102k and the 872k dragon-class knot (``knot_zoo_scene``, its
default 64-triangle leaves) at 512x512, ``spp`` (default 8), depth 50,
untextured, at ``packet_width`` 64 and 128 on one scene each; each arm
warmed by 1 spp (the JAX script warms with a whole frame), then timed
three times in turns, the best of 3 kept. ``packet_width`` sized the
TPU's packet leaf blocks; the port's per-ray kernels take no packet
width (``engine/wavefront.py``), so both arms run the same kernels on the
same tables and render the same image: what differs between them is
the run's spread. Each line prints the tier. Needs a CUDA device; prints
the card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import sys
from typing import Dict

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments.arms import Arm, Reading, run_arms
from tpu_pathtracer_torch.experiments.common import card
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene

NS = 8
SCENES = {"knot": {}, "dragon": {"nu": 1664, "nv": 262}}
WIDTHS = (64, 128)
CONFIG = dict(nx=512, ny=512, max_depth=50, textures=False)
REPS = 3


def measure(device, ns: int = NS, scenes: dict = SCENES,
            widths=WIDTHS, config: dict = CONFIG, reps: int = REPS
            ) -> Dict[str, Dict[str, Reading]]:
    """{scene: {"w=<width>": reading}}: each scene's widths timed in
    turns."""
    cfg = RenderConfig(ns=ns, **config)
    out = {}
    for sname, skw in scenes.items():
        scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, device=device, **skw)
        out[sname] = run_arms([Arm(f"w={w}", scene, cam,
                                   cfg.replace(packet_width=w))
                               for w in widths], ns, reps=reps)
    return out


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    dev = card("width_e2e_ab")
    ns = int(args[0]) if args and args[0].isdigit() else NS
    flags = [a for a in args if not a.isdigit()]
    scenes = {k: v for k, v in SCENES.items()
              if not (k == "knot" and "--dragon-only" in flags
                      or k == "dragon" and "--knot-only" in flags)}
    for sname, arms in measure(dev, ns, scenes).items():
        print(f"{sname}:", flush=True)
        for r in arms.values():
            print(f"  {r.name:5s}: {r.seconds:.3f} s ({r.ms_per_spp:.1f} "
                  f"ms/spp) mean={r.mean:.4f}; {r.line()}", flush=True)


if __name__ == "__main__":
    main()
