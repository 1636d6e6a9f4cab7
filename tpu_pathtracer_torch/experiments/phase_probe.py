"""Width sweep of the heap-BVH kernels with walk telemetry, on the card:
the port's counterpart of ``experiments/phase_probe.py``, the A/B that
decided the JAX package's multirow kernel.

    python -m tpu_pathtracer_torch.experiments.phase_probe [--dragon] [w ...]

For each leaf width w (default 32, 64 and 128) it builds
``knot_zoo_scene(512, 512, prims_per_leaf=w)`` (``--dragon``: at
nu=1664, nv=262, the 872k-triangle dragon-class knot), takes 65,536
primary rays (a 256x256 pixel grid of its camera, sample 0) and times one
nearest-hit traversal of them through K5 (``cuda_bvh.heap_trace``), K12a
(``cuda_bvh_mr.mr_trace``, the packet walk) and K10
(``cuda_bvh_mx.mx_trace``, 3 passes) with CUDA events, each time the
median of 7 runs after a warm-up run. K5 and K12a read the same tables,
so they run in turns: ROUNDS rounds of K5, K12a, K12a, K5, each round
giving the ratio K12a / K5 of its two pairs' means; the ratios' spread
says whether one of them is ahead at that width. K10 runs after them, on
its own, so that the L2 holds its tables as it does in a render (the
MXU-leaf test columns of the dragon are 84 MB, past the 50 MB L2). It
checks that K12a's t equals K5's, then prints per kernel the ms per
traversal (the median over rounds) and the node steps (nodes_both +
nodes_single) and leaf visits: for K12a per 32-ray packet, a count every
lane of the warp takes; for K5 and K10, which walk per ray, per ray and
as the most that one lane of a 32-ray warp takes (the steps the warp
issues).

The rays stay in pixel order. The TPU probe sorted them by the engine's
coherence key; the port removed that sort (ROADMAP A-12), and 32
consecutive pixels of a row already form a coherent warp.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh_mr as cmr
from tpu_pathtracer_torch.ops import cuda_bvh_mx as cmx
from tpu_pathtracer_torch.ops.vec import FLT_MAX

RAYS = 65_536
REPS = 7
ROUNDS = 4
T_MIN = 1e-3  # the TPU probe's


def _event_ms(fn) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _per_ray(cnt: torch.Tensor) -> str:
    """Steps and leaves of a per-ray counter block [5, N]: mean per ray,
    and the mean over 32-ray warps of the most one lane takes."""
    steps = (cnt[0] + cnt[1]).double()
    leaves = cnt[2].double()
    warp = lambda c: c.view(-1, cmr.LANES).max(dim=1).values.mean().item()
    return (f"steps/ray {steps.mean().item():7.1f} (warp max "
            f"{warp(steps):7.1f})  leaves/ray {leaves.mean().item():6.1f} "
            f"(warp max {warp(leaves):6.1f})")


def _per_packet(cnt: torch.Tensor) -> str:
    c = cnt.double()
    return (f"steps/packet {(c[0] + c[1]).mean().item():7.1f}  "
            f"leaves/packet {c[2].mean().item():6.1f}")


def probe(width: int, mesh_kw: dict, dev) -> None:
    scene, cam = knot_zoo_scene(512, 512, prims_per_leaf=width, device=dev,
                                **mesh_kw)
    side = int(RAYS ** 0.5)
    pix = torch.arange(RAYS, device=dev)
    o, d = cam.generate_rays(pix, 0, side, side)
    tabs = cb.heap_tables(scene.mesh)
    mx_tabs = cmx.mx_tables(scene.mesh)
    runs = {"K5 heap_trace": lambda: cb.heap_trace(o, d, FLT_MAX, tabs,
                                                   T_MIN),
            "K12a mr_trace": lambda: cmr.mr_trace(o, d, FLT_MAX, tabs,
                                                  T_MIN),
            "K10 mx_trace": lambda: cmx.mx_trace(o, d, FLT_MAX, mx_tabs,
                                                 T_MIN, 3)}
    outs = {name: fn() for name, fn in runs.items()}  # warm-up
    med = lambda fn: statistics.median(_event_ms(fn) for _ in range(REPS))
    k5, k12 = runs["K5 heap_trace"], runs["K12a mr_trace"]
    times = {"K5 heap_trace": [], "K12a mr_trace": []}
    ratios = []
    for _ in range(ROUNDS):
        a, b, c, e = med(k5), med(k12), med(k12), med(k5)
        times["K5 heap_trace"] += [a, e]
        times["K12a mr_trace"] += [b, c]
        ratios.append((b + c) / (a + e))
    times["K10 mx_trace"] = [med(runs["K10 mx_trace"])]
    t5, tri5, _ = outs["K5 heap_trace"]
    (t12, *_), _ = outs["K12a mr_trace"]
    if not torch.equal(t12, t5):
        raise AssertionError(f"width {width}: K12a's t differs from K5's on "
                             f"{int((t12 != t5).sum())} rays")
    print(f"width={width} tris={scene.mesh.num_tris} "
          f"first_leaf={tabs.first_leaf} hits={int((tri5 >= 0).sum())}",
          flush=True)
    for name in runs:
        ms = statistics.median(times[name])
        cnt = outs[name][1] if name.startswith("K12a") else outs[name][2]
        text = _per_packet(cnt) if name.startswith("K12a") else _per_ray(cnt)
        print(f"  {name:14s} {ms:7.3f} ms/trav ({RAYS / ms / 1e3:6.1f} "
              f"Mrays/s)  {text}", flush=True)
    print(f"  K12a / K5 in turns, by round: "
          f"{' '.join(f'{r:.3f}' for r in ratios)} (min {min(ratios):.3f}, "
          f"max {max(ratios):.3f})", flush=True)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        sys.exit("phase_probe: no CUDA device; the kernels have no CPU mode")
    mesh_kw = {}
    if argv and argv[0] == "--dragon":
        mesh_kw = {"nu": 1664, "nv": 262}
        argv = argv[1:]
    widths = [int(w) for w in argv] or [32, 64, 128]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for w in widths:
        probe(w, mesh_kw, dev)


if __name__ == "__main__":
    main()
