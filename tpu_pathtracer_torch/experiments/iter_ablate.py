"""K5's heap walk in three ablated modes (K13): the CUDA kernel
``csrc/iter_ablate.cu``, its plain PyTorch version, and the probe that
splits K5's time on the card into its node walk, its leaf-row fetch and
its leaf arithmetic. The port's counterpart of
``experiments/iter_ablate.py`` (``_kernel_ablate``, through
``trace_ablate``).

    python -m tpu_pathtracer_torch.experiments.iter_ablate [--dragon] [w] \\
        [parent=FILE.cu]
    python -m tpu_pathtracer_torch.experiments.iter_ablate --frame \\
        [parent=FILE.cu]

The three modes walk as K5 (``ops/cuda_bvh.py`` ``heap_trace``) does,
node steps a thread a ray and leaf visits by the warp, LEAF_LANES lanes
a (ray, leaf) pair, with closest held at t_max, so no hit commits and
every mode visits the same nodes and leaves; a leaf visit does, by mode,
``full``: K5's slot tests, summing t over the accepted slots in the
kernel's order (:func:`leaf_sums`); ``nomt``: the same row loads folded
into an integer xor; ``noleaf``: nothing but the leaf phase's wait, batch
and broadcast (the walk pops). The contract is spelled out in
``csrc/iter_ablate.cu``. :func:`ablate_trace` dispatches on the device of
its inputs: CPU tensors go to the plain version (``cuda_bvh``'s heap walk
with a leaf step that never commits), CUDA tensors to the kernel or the
call raises.

``main()`` builds ``knot_zoo_scene(512, 512, prims_per_leaf=w)`` (w = 64
by default; ``--dragon``: the 872k-triangle knot, nu=1664, nv=262), takes
65,536 primary rays in pixel order (a 256x256 grid of its camera, sample
0; the TPU probe sorted them, the port does not: ROADMAP A-12) and runs
:func:`measure` twice: with closest held at t_max, as the TPU probe does
(no culling: a superset of K5's visits), and at each ray's K5 hit t (a
subset of them). Each time it holds the modes against their plain walks,
times ``full``, ``nomt``, ``noleaf``, a ``parent`` source's of each if
given (a source with the same C entry, say the first form, a thread a ray
with its own leaf loop: commit 68d9d84's ``csrc/iter_ablate.cu``) and the
production K5 in turns (device time a call in a CUDA graph, ROUNDS
rounds) and prints each one's ms, the per-ray steps and leaf visits, and
the split, as ms and as shares of ``full``: node walk = ``noleaf``,
leaf-row fetch = ``nomt`` - ``noleaf``, leaf arithmetic = ``full`` -
``nomt``. ``--frame`` runs it instead on ``chip_smoke.py`` phase 10d's
sets: the dragon frame's 131,072 primary rays from across the frame and
its 196,608-lane pool (``bvh_ab.fixed_sets``), at the frame's epsilon.
"""

from __future__ import annotations

import ctypes
import itertools
import re
import sys
from pathlib import Path
from typing import Optional, Tuple

import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments import bvh_ab
from tpu_pathtracer_torch.experiments.common import (ISSUE_RATE,
                                                     backward_loops, build,
                                                     card, distinct,
                                                     fast_count,
                                                     graph_rounds, median_ms,
                                                     per_ray, sass_functions)
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
LEAF_LANES = 16  # csrc/iter_ablate.cu kLeafLanes: the lanes of a pair


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


def leaf_sums(t: torch.Tensor, ok: torch.Tensor,
              lanes: int = LEAF_LANES) -> torch.Tensor:
    """[M]: the kernel's sum of ``t`` [M, P] over the accepted slots
    ``ok`` of each leaf visit. Lane s of the visit's ``lanes`` adds the t
    of its accepted slots s, s + lanes, ... in slot order (the tail lanes
    of a leaf whose width is no multiple test nothing and hold 0); the
    lanes' partials are then added in a fixed tree, neighbours first
    (``__shfl_xor_sync`` at offsets 1, 2, 4, ...)."""
    m, p = t.shape
    part = torch.where(ok, t, 0.0)
    part = torch.nn.functional.pad(part, (0, -p % lanes)).view(m, -1, lanes)
    acc = part[:, 0]
    for k in range(1, part.shape[1]):
        acc = acc + part[:, k]
    while acc.shape[1] > 1:
        acc = acc[:, 0::2] + acc[:, 1::2]
    return acc[:, 0]


def _ablate_ref(origin: V3, direction: V3, tmax: torch.Tensor,
                tabs: cb.HeapTables, t_min: float, mode: str,
                visits: Optional[dict] = None):
    """(acc [N], counters [5, N] int32): the kernel's walk with every ray
    advancing one step per pass, through ``cuda_bvh``'s heap walk with a
    leaf step that never commits. acc is float32 (``full``: each leaf
    visit's :func:`leaf_sums` added in visit order) or int32 (``nomt``:
    the xor of the visited leaves' words; ``noleaf``: 0). ``visits`` as
    for ``cuda_bvh.HeapWalk``."""
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
            acc[lanes] = acc[lanes] + leaf_sums(t, ok)
        elif mode == "nomt":
            bits[lanes] ^= words[base // P]
        none = torch.zeros_like(lanes, dtype=torch.bool)
        return none, walk.closest[lanes], torch.zeros_like(lanes), \
            torch.zeros_like(lanes)

    *_, cnt = cb._heap_walk_ref(origin, direction, tmax, tabs, t_min,
                                any_hit=False, visits=visits,
                                leaf_test=leaf_test)
    return (acc if mode == "full" else bits), cnt


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (the package's build or another source's) with
    ``iter_ablate_launch``'s signature set."""
    fn = lib.iter_ablate_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([ctypes.c_int] + [p] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int] + [p] * 3)
        fn.restype = ctypes.c_int
    return lib


def source_lib(path: Path, out: Optional[Path] = None) -> ctypes.CDLL:
    """Another source of the kernel with the same C entry (a parent),
    built by ``common.build`` and bound; ``out`` keeps its ptxas lines
    and SASS."""
    lib, _ = build("iter_ablate_parent", Path(path).read_text(), out)
    return bind(ctypes.CDLL(str(lib)))


def _launch(origin: V3, direction: V3, tmax: torch.Tensor,
            tabs: cb.HeapTables, t_min: float, mode: str,
            lib: Optional[ctypes.CDLL] = None):
    """One launch through ``lib`` (default: the package's build, counted
    in LAUNCHES; another library's launches are not counted)."""
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
            rc = (lib or bind(_build.load("iter_ablate"))).iter_ablate_launch(
                MODES.index(mode),
                *(a.data_ptr() for a in (*origin, *direction, tmax)),
                tabs.nodes.data_ptr(), tabs.tri.data_ptr(), tabs.first_leaf,
                tabs.prims_per_leaf, float(t_min), n, acc.data_ptr(),
                cnt.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"iter_ablate kernel launch failed: CUDA "
                               f"error {rc}")
        if lib is None:
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
            t_min: float, at_k5_hits: bool = False, rounds: int = ROUNDS,
            parent: Optional[ctypes.CDLL] = None,
            time_plain: bool = True) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 10d print it). Each mode runs once and is held
    bit-equal to its plain walk (acc and counters; the modes' counters
    equal); ``parent`` (:func:`source_lib`), if given, is held to the same
    counters and, in ``nomt`` and ``noleaf``, the same acc (its ``full``
    may sum in another order: the first form's sums in slot order). Then
    K5 (``cuda_bvh.heap_trace`` at ``t_max``), the three modes and the
    parent's are timed in turns: device time a call in a CUDA graph
    (``common.graph_rounds``), ``rounds`` rounds. The modes hold closest
    at ``t_max``, or with ``at_k5_hits`` at each ray's K5 hit t: a subset
    of K5's own visits, where the default walk (no culling) visits a
    superset.

    Returns a dict: ``launches`` (LAUNCHES after the checked run),
    ``counters`` (the modes' and K5's [5, N]), ``nodes`` and ``leaves``
    (the distinct rows the walk read), ``ms`` by name (K5, the modes,
    ``parent <mode>``; :func:`split_text` splits them) and ``plain_ms``
    by mode (one reading each; empty unless ``time_plain``)."""
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
        if time_plain:
            plain_ms[m] = median_ms(plain, reps=2)
    if not all(torch.equal(outs[m][1], outs["full"][1]) for m in MODES):
        raise AssertionError("the modes visit different nodes or leaves")
    # the timed calls go through the library itself: LAUNCHES keeps the
    # checked run's count
    lib = bind(_build.load("iter_ablate"))
    calls = {"K5": k5}
    for m in MODES:
        calls[m] = lambda m=m: _launch(origin, direction, hold, tabs, t_min,
                                       m, lib)
    if parent is not None:
        for m in MODES:
            calls[f"parent {m}"] = lambda m=m: _launch(
                origin, direction, hold, tabs, t_min, m, parent)
            acc, cnt = calls[f"parent {m}"]()
            if not (torch.equal(cnt, outs[m][1])
                    and (m == "full" or torch.equal(acc, outs[m][0]))):
                raise AssertionError(f"the parent's {m} differs from the "
                                     "kernel's counters or acc")
    names = list(calls)
    ms = {name: v for (name, _), v in graph_rounds(
        names, [None], lambda name, _: calls[name](), rounds).items()}
    return {"launches": launches,
            "counters": {"modes": outs["full"][1], "K5": k5()[2]},
            "nodes": distinct(visits["nodes"]),
            "leaves": distinct(visits["leaves"]),
            "ms": ms, "plain_ms": plain_ms}


def split_of(ms: dict, prefix: str = "") -> dict:
    """The split of ``full`` in ms: node walk, leaf-row fetch, leaf
    arithmetic, from the modes' times (``prefix``: whose)."""
    full, nomt, noleaf = (ms[prefix + m] for m in MODES)
    return {"node walk": noleaf, "leaf-row fetch": nomt - noleaf,
            "leaf arithmetic": full - nomt}


def split_text(r: dict, prefix: str = "") -> str:
    """The split of ``full`` in a :func:`measure` result (``prefix``:
    "" the kernel's, "parent " the parent's), as ms and shares, with
    K5 beside it."""
    ms = r["ms"]
    full = ms[prefix + "full"]
    return (", ".join(f"{k} {v:.4f} ms ({v / full:.1%})"
                      for k, v in split_of(ms, prefix).items())
            + f"; K5 {ms['K5']:.4f} ms, K5 / full {ms['K5'] / full:.3f}")


def mode_sass(text: str) -> dict:
    """{mode: (slot, node, round)} of the ablate kernels in a ``cuobjdump
    -sass`` dump (by the mangled name's template argument): the warp
    instructions of a slot test (the leaf phase's slot loop; 0 in
    ``noleaf``), of a node step (the walk loop without its leaf phase)
    and of a leaf phase's round without its slot loop (the selection, the
    broadcasts, the tree, the pops and the ballot), each without the
    IEEE division's slow path. The walk loop is the function's widest
    loop, the leaf phase's the widest inside it, the slot loop the one
    inside that."""
    out = {}
    for name, code in sass_functions(text).items():
        m = re.search(r"ablate_kernelILi(\d)E", name)
        if not m:
            continue
        loops = sorted(backward_loops(code), key=lambda s: s[0] - s[1])
        inside = lambda s, o: o[0] <= s[0] and s[1] <= o[1] and s != o
        walk = loops[0]
        leaf = next(s for s in loops if inside(s, walk))
        slot = [s for s in loops if inside(s, leaf)]
        n_slot = fast_count(code, slot[0]) if slot else 0
        n_leaf = fast_count(code, leaf)
        out[MODES[int(m.group(1))]] = (n_slot, fast_count(code, walk)
                                       - n_leaf, n_leaf - n_slot)
    return out


def issue_floor(sass: tuple, cnt: torch.Tensor, P: int) -> Tuple[float, int]:
    """(ms, warp instructions): the least time the card could issue a
    mode's SASS (``sass``: :func:`mode_sass`'s (slot, node, round)) for a
    run's per-ray counters ``cnt`` at ``common.ISSUE_RATE``: a slot test a
    lane for every slot of every leaf visit, a node step a lane for every
    step, and a round on LEAF_LANES lanes for every visit."""
    slot, node, rnd = sass
    c = cnt.sum(dim=1, dtype=torch.int64)
    lanes = (int(c[2]) * (P * slot + LEAF_LANES * rnd) + int(c[4]) * node)
    return lanes / 32 / ISSUE_RATE * 1e3, lanes // 32


def _frame_sets(dev) -> Tuple[cb.HeapTables, float, dict]:
    """(tables, epsilon, {name: (origin, direction)}): the dragon frame's
    primary rays of ``chip_smoke.py`` phase 10d (``bvh_ab.fixed_sets``)."""
    cfg = RenderConfig(**bvh_ab.DRAGON)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, device=dev,
                                **bvh_ab.DRAGON_MESH)
    sets = bvh_ab.fixed_sets(scene, cam, cfg)
    return cb.heap_tables(scene.mesh), cfg.epsilon, {
        name: sets[name][1:3] for name in ("primary", "pool primary")}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    src = [a.split("=", 1)[1] for a in argv if a.startswith("parent=")]
    argv = [a for a in argv if not a.startswith("parent=")]
    frame = "--frame" in argv
    mesh_kw = {}
    if argv and argv[0] == "--dragon":
        mesh_kw = DRAGON
        argv = argv[1:]
    width = 64 if frame or not argv else int(argv[0])
    dev = card("iter_ablate")
    parent = source_lib(src[0]) if src else None
    if frame:
        tabs, t_min, sets = _frame_sets(dev)
        what = "the dragon frame's sets"
    else:
        scene, cam = knot_zoo_scene(512, 512, prims_per_leaf=width,
                                    device=dev, **mesh_kw)
        side = int(RAYS ** 0.5)
        sets = {"primary": cam.generate_rays(torch.arange(RAYS, device=dev),
                                             0, side, side)}
        tabs, t_min = cb.heap_tables(scene.mesh), T_MIN
        what = f"knot {scene.mesh.num_tris} slots, width {width}"
    print(f"{what}, first_leaf {tabs.first_leaf}; each mode bit-equal to its "
          f"plain walk; in turns with K5"
          f"{' and the parent' if parent else ''}, device time a call in a "
          f"CUDA graph, median of {ROUNDS} rounds", flush=True)
    for (name, (o, d)), (at_k5_hits, what) in itertools.product(
            sets.items(), ((False, "closest held at t_max: no culling, a "
                            "superset of K5's visits"),
                           (True, "closest held at K5's hit t: a subset of "
                            "K5's visits"))):
        r = measure(o, d, FLT_MAX, tabs, t_min, at_k5_hits, parent=parent)
        print(f" {name}, {o.x.shape[0]} rays: {what}", flush=True)
        for name in ("K5", *MODES):
            cnt = r["counters"]["K5" if name == "K5" else "modes"]
            extra = ""
            if name in MODES:
                par = (f"parent {r['ms']['parent ' + name]:.4f}, "
                       if parent else "")
                extra = f" ({par}plain {r['plain_ms'][name]:.1f})"
            print(f"  {name:6s} {r['ms'][name]:8.4f} ms{extra}  "
                  f"{per_ray(cnt)}", flush=True)
        print(f"  split of full: {split_text(r)}", flush=True)
        if parent:
            print(f"  the parent's: {split_text(r, 'parent ')}", flush=True)


if __name__ == "__main__":
    main()
