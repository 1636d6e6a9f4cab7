"""K5's heap walk in three ablated modes (K13): the CUDA kernel
``csrc/iter_ablate.cu``, its plain PyTorch version, and the probe that
splits K5's time on the card into its node walk, its leaf-row fetch and
its leaf arithmetic. The port's counterpart of
``experiments/iter_ablate.py`` (``_kernel_ablate``, through
``trace_ablate``).

    python -m tpu_pathtracer_torch.experiments.iter_ablate [--dragon] [w]

The three modes walk as K5 (``ops/cuda_bvh.py`` ``heap_trace``) does with
closest held at t_max, so no hit commits and every mode visits the same
nodes and leaves; a leaf visit does, by mode, ``full``: K5's leaf loop,
summing t over the accepted slots; ``nomt``: the same row loads folded
into an integer xor; ``noleaf``: nothing (the walk pops). The contract
is spelled out in ``csrc/iter_ablate.cu``. :func:`ablate_trace`
dispatches on the device of its inputs: CPU tensors go to the plain
version (``cuda_bvh``'s heap walk with a leaf step that never commits),
CUDA tensors to the kernel or the call raises.

``main()`` builds ``knot_zoo_scene(512, 512, prims_per_leaf=w)`` (w = 64
by default; ``--dragon``: the 872k-triangle knot, nu=1664, nv=262), takes
65,536 primary rays in pixel order (a 256x256 grid of its camera, sample
0; the TPU probe sorted them, the port does not: ROADMAP A-12) and runs
:func:`measure` twice: with closest held at t_max, as the TPU probe does
(no culling: a superset of K5's visits), and at each ray's K5 hit t (a
subset of them). Each time it holds the modes against their plain walks,
times ``full``, ``nomt``, ``noleaf`` and the production K5 in turns (4
rounds of the four forward and back, each reading the median of 7 calls)
and prints each one's ms, the per-ray steps and leaf visits, and the
split, as ms and as shares of ``full``: node walk = ``noleaf``, leaf-row
fetch = ``nomt`` - ``noleaf``, leaf arithmetic = ``full`` - ``nomt``.
"""

from __future__ import annotations

import ctypes
import statistics
import sys
from typing import Optional, Tuple

import torch

from tpu_pathtracer_torch.experiments.common import (card, distinct, in_turns,
                                                     median_ms, per_ray)
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops.cuda_spheres import _on_cuda, _tmax_vector
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

MODES = ("full", "nomt", "noleaf")  # csrc/iter_ablate.cu Mode, in order
# Kernel launches by ablate_trace, per mode. Callers reset them to 0 and
# read them back to show that a run went through the kernel.
LAUNCHES = {mode: 0 for mode in MODES}
RAYS = 65_536
T_MIN = 1e-3  # the TPU probe's
ROUNDS = 4
DRAGON = {"nu": 1664, "nv": 262}


def leaf_xor(tabs: cb.HeapTables) -> torch.Tensor:
    """int32 [first_leaf]: the xor of the 32-bit words of each leaf's
    triangle rows, what ``nomt`` folds a visit into."""
    P = tabs.prims_per_leaf
    x = tabs.tri[:tabs.first_leaf * P].contiguous().view(torch.int32)
    x = x.reshape(tabs.first_leaf, -1)
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        x = x[:, 0::2] ^ x[:, 1::2]
    return x[:, 0]


def _ablate_ref(origin: V3, direction: V3, tmax: torch.Tensor,
                tabs: cb.HeapTables, t_min: float, mode: str,
                visits: Optional[dict] = None):
    """(acc [N], counters [5, N] int32): the kernel's walk with every ray
    advancing one step per pass, through ``cuda_bvh``'s heap walk with a
    leaf step that never commits. acc is float32 (``full``: t summed over
    the accepted slots in the kernel's order) or int32 (``nomt``: the xor
    of the visited leaves' words; ``noleaf``: 0). ``visits`` as for
    ``cuda_bvh.HeapWalk``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    n = origin.x.shape[0]
    dev = origin.x.device
    P = tabs.prims_per_leaf
    slots = torch.arange(P, device=dev)
    acc = torch.zeros((n,), dtype=torch.float32, device=dev)
    bits = torch.zeros((n,), dtype=torch.int32, device=dev)
    words = leaf_xor(tabs) if mode == "nomt" else None

    def leaf_test(walk, lanes, base):
        if mode == "full":
            rows = tabs.tri[base[:, None] + slots]  # [M, P, 12]
            t, ok = cb.mt_rows(rows, walk.o[lanes], walk.d[lanes], t_min,
                               walk.closest[lanes])
            a = acc[lanes]
            for k in range(P):  # the kernel's order: slot by slot
                a = a + torch.where(ok[:, k], t[:, k], 0.0)
            acc[lanes] = a
        elif mode == "nomt":
            bits[lanes] ^= words[base // P]
        none = torch.zeros_like(lanes, dtype=torch.bool)
        return none, walk.closest[lanes], torch.zeros_like(lanes), \
            torch.zeros_like(lanes)

    *_, cnt = cb._heap_walk_ref(origin, direction, tmax, tabs, t_min,
                                any_hit=False, visits=visits,
                                leaf_test=leaf_test)
    return (acc if mode == "full" else bits), cnt


def _lib() -> ctypes.CDLL:
    lib = _build.load("iter_ablate")
    fn = lib.iter_ablate_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([ctypes.c_int] + [p] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int] + [p] * 3)
        fn.restype = ctypes.c_int
    return lib


def _launch(origin: V3, direction: V3, tmax: torch.Tensor,
            tabs: cb.HeapTables, t_min: float, mode: str):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    if tabs.tri.shape[1:] != (12,):
        raise ValueError("triangle rows must be [T, 12]")
    dev, n = cb.check_walk_inputs(origin, direction, tmax, tabs, tabs.tri,
                                  "triangle")
    acc = torch.empty((n,), dtype=torch.int32, device=dev)
    cnt = torch.empty((5, n), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().iter_ablate_launch(
                MODES.index(mode),
                *(a.data_ptr() for a in (*origin, *direction, tmax)),
                tabs.nodes.data_ptr(), tabs.tri.data_ptr(), tabs.first_leaf,
                tabs.prims_per_leaf, float(t_min), n, acc.data_ptr(),
                cnt.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"iter_ablate kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES[mode] += 1
    return (acc.view(torch.float32) if mode == "full" else acc), cnt


def ablate_trace(origin: V3, direction: V3, t_max, tabs: cb.HeapTables,
                 t_min: float, mode: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's walk in ablated ``mode`` (``MODES``) with closest held at
    t_max: (acc [N], float32 in ``full``, int32 in ``nomt`` and
    ``noleaf``; per-ray counters [5, N] int32, ``cuda_bvh.COUNTERS``)."""
    tmax = _tmax_vector(t_max, origin.x.shape[0], origin.x)
    if _on_cuda(origin):
        return _launch(origin, direction, tmax, tabs, t_min, mode)
    return _ablate_ref(origin, direction, tmax, tabs, t_min, mode)


def measure(origin: V3, direction: V3, t_max, tabs: cb.HeapTables,
            t_min: float, at_k5_hits: bool = False,
            rounds: int = ROUNDS) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 10d print it). Each mode runs once and is held
    bit-equal to its plain walk (acc and counters; the modes' counters
    equal); then the three modes and K5 (``cuda_bvh.heap_trace`` at
    ``t_max``) are timed in turns. The modes hold closest at ``t_max``, or
    with ``at_k5_hits`` at each ray's K5 hit t: a subset of K5's own
    visits, where the default walk (no culling) visits a superset.

    Returns a dict: ``launches`` (LAUNCHES after the checked run),
    ``counters`` (the modes' and K5's [5, N]), ``nodes`` and ``leaves``
    (the distinct rows the walk read), ``readings`` and ``ms`` (their
    median) by name, ``plain_ms`` by mode and ``split`` (ms of the node
    walk, the leaf-row fetch and the leaf arithmetic)."""
    n = origin.x.shape[0]
    tmax = _tmax_vector(t_max, n, origin.x)
    k5 = lambda: cb.heap_trace(origin, direction, tmax, tabs, t_min)
    hold = k5()[0] if at_k5_hits else tmax
    outs = {m: ablate_trace(origin, direction, hold, tabs, t_min, m)
            for m in MODES}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    visits = {"nodes": [], "leaves": []}
    plain_ms = {}
    for m in MODES:
        plain = lambda v=None, m=m: _ablate_ref(origin, direction, hold,
                                                tabs, t_min, m, v)
        want = plain(visits if m == "full" else None)
        if not all(torch.equal(a, b) for a, b in zip(outs[m], want)):
            bad = (outs[m][1] != want[1]).any(0)
            raise AssertionError(f"{m}: differs from its plain walk on "
                                 f"{int((outs[m][0] != want[0]).sum())} "
                                 f"lanes' acc, {int(bad.sum())} lanes' "
                                 "counters")
        plain_ms[m] = median_ms(plain, reps=2)
    if not all(torch.equal(outs[m][1], outs["full"][1]) for m in MODES):
        raise AssertionError("the modes visit different nodes or leaves")
    readings = in_turns({"K5": k5, **{m: (lambda m=m: ablate_trace(
        origin, direction, hold, tabs, t_min, m)) for m in MODES}},
        rounds)
    ms = {name: statistics.median(v) for name, v in readings.items()}
    return {"launches": launches,
            "counters": {"modes": outs["full"][1], "K5": k5()[2]},
            "nodes": distinct(visits["nodes"]),
            "leaves": distinct(visits["leaves"]),
            "readings": readings, "ms": ms, "plain_ms": plain_ms,
            "split": {"node walk": ms["noleaf"],
                      "leaf-row fetch": ms["nomt"] - ms["noleaf"],
                      "leaf arithmetic": ms["full"] - ms["nomt"]}}


def split_text(r: dict) -> str:
    """The split of ``full`` in a :func:`measure` result, as ms and shares,
    with K5 beside it."""
    ms, full = r["ms"], r["ms"]["full"]
    return (", ".join(f"{k} {v:.3f} ms ({v / full:.1%})"
                      for k, v in r["split"].items())
            + f"; K5 {ms['K5']:.3f} ms, K5 / full {ms['K5'] / full:.3f}")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    mesh_kw = {}
    if argv and argv[0] == "--dragon":
        mesh_kw = DRAGON
        argv = argv[1:]
    width = int(argv[0]) if argv else 64
    dev = card("iter_ablate")
    scene, cam = knot_zoo_scene(512, 512, prims_per_leaf=width, device=dev,
                                **mesh_kw)
    side = int(RAYS ** 0.5)
    o, d = cam.generate_rays(torch.arange(RAYS, device=dev), 0, side, side)
    tabs = cb.heap_tables(scene.mesh)
    print(f"knot {scene.mesh.num_tris} slots, width {width}, first_leaf "
          f"{tabs.first_leaf}, {RAYS} pixel-order primary rays; each mode "
          f"bit-equal to its plain walk; in turns with K5, {ROUNDS} rounds "
          f"(median of each name's {2 * ROUNDS} readings, each the median "
          f"of 7)", flush=True)
    for at_k5_hits, what in ((False, "closest held at t_max: no culling, "
                              "a superset of K5's visits"),
                             (True, "closest held at K5's hit t: a subset "
                              "of K5's visits")):
        r = measure(o, d, FLT_MAX, tabs, T_MIN, at_k5_hits)
        print(f" {what}", flush=True)
        for name in ("K5", *MODES):
            cnt = r["counters"]["K5" if name == "K5" else "modes"]
            spread = (f"{min(r['readings'][name]):.3f}-"
                      f"{max(r['readings'][name]):.3f}")
            plain = (f", plain {r['plain_ms'][name]:.1f}"
                     if name in MODES else "")
            print(f"  {name:6s} {r['ms'][name]:7.3f} ms/trav (readings "
                  f"{spread}{plain})  {per_ray(cnt)}", flush=True)
        print(f"  split of full: {split_text(r)}", flush=True)


if __name__ == "__main__":
    main()
