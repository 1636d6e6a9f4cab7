"""V back-to-back visits of every ray to a 64-triangle cluster (K14): the
CUDA kernel ``csrc/leafmt_probe.cu``, its plain PyTorch version, and the
probe that gives a leaf test in the heap kernel's form (K5, ``csrc/bvh.cu``)
with no traversal around it, and the cost of each way of fetching the
cluster to its lanes. The port's counterpart of
``experiments/leafmt_probe.py`` (``_kernel``, through ``run``).

    python -m tpu_pathtracer_torch.experiments.leafmt_probe [--blocks B] \\
        [parent=FILE.cu] [NAME=K:V,...] [--out DIR]

Visit i tests cluster 0 (modes ``pure``, ``cond``) or cluster i % C
(``dma``, ``db``, ``db2``; C = 611), its 64 slots, as a strict-less
nearest update of (closest, besti = i*64 + w) in slot order. The kernel
tests a visit by the warp, as K5 tests a leaf: LEAF_LANES lanes a (ray,
cluster) pair, each lane a slot residue against its own running best,
merged on the least (t, slot) by a shuffle tree. The modes are the TPU
probe's, each in that form (``csrc/leafmt_probe.cu``): the cluster staged
once a block in shared memory (``pure``), plus a branch a visit
(``cond``), read per lane from global memory every visit (``dma``, K5's
fetch), staged one visit ahead into a two-slot ring a warp by the
bulk-copy engine on mbarriers (``db``). ``db2`` computes ``db``'s
function and its dynamic slot is what the ``db`` kernel does anyway, so
the ``db`` kernel serves it (counted under ``db2``). :func:`leafmt_run`
dispatches on the device of its inputs: CPU tensors go to the plain
version, CUDA tensors to the kernel or the call raises.

The inputs are the TPU probe's, from its seed (:func:`probe_arrays`):
611 random 64-triangle clusters in its (C, 16, 128) block layout, which
:func:`clusters_from_blocks` turns into the kernel's [C, 64, 12] rows,
and one (8, 128) tile of rays, repeated. A tile is 8 blocks of 128
threads on 8 SMs. ``main()`` runs :func:`measure` on two shapes
(``SHAPES``): the TPU's one tile at its slope points V = 1024 and 17,408,
and the dragon heap frame's 196,608-lane pool (192 tiles) at V = 128 and
1,152; ``--blocks B`` runs B tiles at the tile's points instead.
``parent=FILE.cu`` (say the first form, a block of 1024 threads a tile:
commit e02d93c's ``csrc/leafmt_probe.cu`` saved under a gitignored
directory) and ``NAME=K:V,...`` (this source with its ``constexpr int
K`` set to V: ``bulk0=kBulk:0`` fills the ring with the lanes'
``cp.async``, ``l2=kDmaL1:0`` reads dma's rows at the L2 only,
``l8=kLeafLanes:8``, ``nofence=kProxyFence:0``) add
sources with the same C entry, held bit-equal and timed in turns with
the kernel. ``--out DIR`` keeps each build's ptxas lines and SASS. It
prints ns a visit and a slot for each mode and source at each shape, and
the B-17 reading: dma - pure (what K5's per-lane fetch costs) and dma -
db (what staging by the bulk copy hides).
"""

from __future__ import annotations

import ctypes
import math
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.experiments.common import (ISSUE_RATE, ab_sources,
                                                     body_loops, build,
                                                     card, fast_count,
                                                     graph_rounds, median_ms,
                                                     opcode, sass_dump,
                                                     sass_functions)
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops.cuda_spheres import _check, _on_cuda
from tpu_pathtracer_torch.ops.v3 import V3

WIDTH = 64     # triangles a cluster
TILE = 1024    # rays a tile: the TPU probe's (8, 128)
CLUSTERS = 611
T_MIN = 1e-3   # the TPU probe's
VISITS = (1024, 17_408)  # the TPU probe's slope points (:214)
POOL_TILES = 192  # the dragon heap frame's 196,608-lane pool
POOL_VISITS = (128, 1_152)  # past the clusters' wrap, a call under ~60 ms
# name: (tiles, (V lo, V hi))
SHAPES = {"tile": (1, VISITS), "pool": (POOL_TILES, POOL_VISITS)}
MODES = ("pure", "cond", "dma", "db", "db2")
_KERNEL_MODE = {"pure": 0, "cond": 1, "dma": 2, "db": 3, "db2": 3}
SERVED_BY = {"db2": "db"}  # a mode that another mode's kernel computes
TIMED = tuple(m for m in MODES if m not in SERVED_BY)
# Kernel launches by leafmt_run, per mode. Callers reset them to 0 and
# read them back to show that a run went through the kernel.
LAUNCHES = {mode: 0 for mode in MODES}
LEAF_LANES = 16  # csrc/leafmt_probe.cu kLeafLanes: the lanes of a pair
_CHUNK = 1 << 22  # ray-slot pairs a pass of the plain version
ROUNDS = 3
CALLS = 2  # calls a CUDA graph: each is milliseconds long


def probe_arrays(C: int = CLUSTERS):
    """The TPU probe's inputs (``experiments/leafmt_probe.py:182-202``):
    (blocks (C, 16, 128) f32, rows 0-2 v0, 3-5 e1, 6-8 e2, 9-11 n = e1 x
    e2, lanes 0-63 live; origins [3, 1024] and unit directions [3, 1024],
    the (8, 128) tile row-major)."""
    rng = np.random.RandomState(0)
    v0 = rng.uniform(-5, 5, (C, WIDTH, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (C, WIDTH, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (C, WIDTH, 3)).astype(np.float32)
    n = np.cross(e1, e2)
    blocks = np.zeros((C, 16, 128), np.float32)
    blocks[:, 0:3, :WIDTH] = v0.transpose(0, 2, 1)
    blocks[:, 3:6, :WIDTH] = e1.transpose(0, 2, 1)
    blocks[:, 6:9, :WIDTH] = e2.transpose(0, 2, 1)
    blocks[:, 9:12, :WIDTH] = n.transpose(0, 2, 1)
    o = rng.uniform(-8, 8, (3, 8, 128)).astype(np.float32)
    d = rng.randn(3, 8, 128).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return blocks, o.reshape(3, TILE), d.reshape(3, TILE)


def clusters_from_blocks(blocks) -> torch.Tensor:
    """The TPU probe's (C, 16, 128) blocks as the kernel's [C, 64, 12]
    rows (v0, e1, e2, n; ``tris.cu``'s layout)."""
    b = torch.as_tensor(blocks)
    return b[:, :12, :WIDTH].transpose(1, 2).contiguous()


def probe_inputs(tiles: int = 1, device="cuda"):
    """(origin, direction, t_max, clusters) on ``device``: the TPU probe's
    arrays, its ray tile repeated ``tiles`` times, t_max 3.4e38."""
    blocks, o, d = probe_arrays()
    v = lambda a: V3(*(torch.from_numpy(np.tile(a[k], tiles)).to(device)
                       for k in range(3)))
    origin, direction = v(o), v(d)
    tmax = torch.full((tiles * TILE,), 3.4e38, dtype=torch.float32,
                      device=device)
    return origin, direction, tmax, clusters_from_blocks(blocks).to(device)


def _leafmt_ref(origin: V3, direction: V3, tmax: torch.Tensor,
                clusters: torch.Tensor, visits: int, mode: str,
                skip: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(closest [N], besti [N] int32): the kernel's visits a pass of up to
    ``_CHUNK`` ray-slot pairs, each pass's slots tested at once and
    reduced to the first strict minimum, which is what the kernel's
    strict-less sequential update keeps. ``cond`` at ``skip`` >= 1 runs no
    visit (its branch is never taken once besti starts at -1)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    o, d = origin.stack(), direction.stack()
    n = o.shape[0]
    closest = tmax.clone()
    best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    if mode == "cond" and skip >= 1:
        visits = 0
    per = max(1, _CHUNK // max(n * WIDTH, 1))
    inf = torch.full((n,), float("inf"), device=o.device)
    for v0 in range(0, visits, per):
        vs = torch.arange(v0, min(visits, v0 + per), device=o.device)
        cl = vs % clusters.shape[0] if _KERNEL_MODE[mode] >= 2 else \
            torch.zeros_like(vs)
        rows = clusters[cl].reshape(1, -1, 12)  # [1, visits x 64, 12]
        t, ok = cb.mt_rows(rows, o, d, T_MIN, inf)
        tv = torch.where(ok, t, inf[:, None])
        m = tv.min(dim=1).values
        better = m < closest
        first = (ok & (t == m[:, None])).to(torch.uint8).argmax(dim=1)
        best = torch.where(better, v0 * WIDTH + first, best)
        closest = torch.where(better, m, closest)
    return closest, best.to(torch.int32)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (the package's build or another source's) with its C
    entries' signatures set."""
    fn = lib.leafmt_probe_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([ctypes.c_int] + [p] * 8 + [ctypes.c_int] * 4
                       + [p] * 3)
        fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return bind(_build.load("leafmt_probe"))


def source_lib(name: str, text: str, out: Optional[Path] = None):
    """(library, ptxas lines) of another source of the kernel with the same
    C entry (a parent, a variant), built by ``common.build`` as
    ``leafmt_<name>`` and bound; ``out`` keeps its ptxas lines and SASS."""
    lib, ptxas = build(f"leafmt_{name}", text, out)
    return bind(ctypes.CDLL(str(lib))), ptxas


def _launch(origin: V3, direction: V3, tmax: torch.Tensor,
            clusters: torch.Tensor, visits: int, mode: str, skip: int = 0,
            lib: Optional[ctypes.CDLL] = None):
    """One launch through ``lib`` (default: the package's build, counted
    in LAUNCHES; another library's launches are not counted)."""
    dev = origin.x.device
    n = origin.x.shape[0]
    if n % TILE:
        raise ValueError(f"{n} rays are no whole number of {TILE}-ray tiles")
    f32 = torch.float32
    for name, a in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t_max"),
                       (*origin, *direction, tmax)):
        _check(name, a, dev, f32, (n,))
    C = clusters.shape[0]
    _check("clusters", clusters, dev, f32, (C, WIDTH, 12))
    if clusters.data_ptr() % 16:
        raise ValueError("clusters must be 16-byte aligned (float4)")
    closest = torch.empty((n,), dtype=f32, device=dev)
    best = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = (lib or _lib()).leafmt_probe_launch(
                _KERNEL_MODE[mode],
                *(a.data_ptr() for a in (*origin, *direction, tmax)),
                clusters.data_ptr(), C, int(visits), int(skip), n,
                closest.data_ptr(), best.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"leafmt_probe kernel launch failed: CUDA "
                               f"error {rc}")
        if lib is None:
            LAUNCHES[mode] += 1
    return closest, best


def leafmt_run(origin: V3, direction: V3, tmax: torch.Tensor,
               clusters: torch.Tensor, visits: int, mode: str = "pure",
               skip: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``visits`` visits of every ray (N a multiple of 1024) in ``mode``:
    (closest [N], t_max where nothing hit; besti [N] int32, -1)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    if not _on_cuda(origin):
        return _leafmt_ref(origin, direction, tmax, clusters, visits, mode,
                           skip)
    return _launch(origin, direction, tmax, clusters, visits, mode, skip)


def blocks_per_sm(lib: Optional[ctypes.CDLL] = None) -> Dict[str, int]:
    """{mode: resident blocks an SM} of the timed modes' kernels (the
    CUDA occupancy calculator on their threads, registers and shared
    memory)."""
    fn = (lib or _lib()).leafmt_probe_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return {m: fn(_KERNEL_MODE[m]) for m in TIMED}


def _equal(tag: str, got, want) -> None:
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(
            f"{tag}: differs from its plain version on "
            f"{int((got[1] != want[1]).sum())} winners, "
            f"{int((got[0] != want[0]).sum())} t")


def measure(dev, shapes: Optional[Dict[str, tuple]] = None,
            rounds: int = ROUNDS,
            sources: Optional[Dict[str, ctypes.CDLL]] = None) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 15 print it), on :func:`probe_inputs` at each
    of ``shapes`` ({name: (tiles, (V lo, V hi))}, default ``SHAPES``).
    Every mode runs once at each shape's two points, past the clusters'
    wrap, and is held bit-equal to its plain version there; so is each of
    ``sources`` ({name: library with the same C entry}, not counted in
    LAUNCHES). Then the modes and the sources' modes are timed in turns:
    device time a call in a CUDA graph (``common.graph_rounds``,
    ``rounds`` rounds). ``db2`` is checked and counted, and takes ``db``'s
    times: the same kernel (``SERVED_BY``).

    Returns a dict: ``launches`` (LAUNCHES after the checked runs), ``n``
    (rays by shape), ``ms`` by (name, shape, V), name a mode or "<source>
    <mode>", ``per_visit`` by (name, shape) (ns, the slope), ``plain_ms``
    by (mode, shape) at V lo (``pure`` and ``cond`` share one function,
    the rest another), ``hits`` by (mode, shape) (rays with a winner at V
    lo) and ``blocks_per_sm`` by mode."""
    shapes = SHAPES if shapes is None else shapes
    sources = sources or {}
    args = {s: probe_inputs(tiles, dev) for s, (tiles, _) in shapes.items()}
    cells = [(s, v) for s, (_, vs) in shapes.items() for v in vs]
    outs = {(m, c): leafmt_run(*args[c[0]], c[1], m)
            for m in MODES for c in cells}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    plain_ms = {}
    for s, v in cells:
        for fn in ("pure", "dma"):  # the two functions the modes compute
            want = _leafmt_ref(*args[s], v, fn)
            for m in (m for m in MODES
                      if (_KERNEL_MODE[m] >= 2) == (fn == "dma")):
                _equal(f"{m} at {s} V={v}", outs[(m, (s, v))], want)
                for src, lib in sources.items():
                    _equal(f"{src} {m} at {s} V={v}",
                           _launch(*args[s], v, m, lib=lib), want)
            if v == shapes[s][1][0]:
                plain_ms[fn, s] = median_ms(
                    lambda: _leafmt_ref(*args[s], v, fn), reps=2)
    calls = {}
    for name, lib in {"": _lib(), **{f"{k} ": v
                                     for k, v in sources.items()}}.items():
        for m in TIMED:
            calls[name + m] = lambda s, v, m=m, lib=lib: _launch(
                *args[s], v, m, lib=lib)
    times = graph_rounds(list(calls), cells,
                         lambda name, cell: calls[name](*cell), rounds,
                         calls=CALLS)
    ms, per_visit = {}, {}
    for name in calls:
        base = name.rsplit(" ", 1)
        for s, (_, (lo, hi)) in shapes.items():
            a, b = times[name, (s, lo)], times[name, (s, hi)]
            ms[name, s, lo], ms[name, s, hi] = a, b
            per_visit[name, s] = (b - a) / (hi - lo) * 1e6
            if base[-1] == "db":  # db2: db's kernel
                alias = " ".join(base[:-1] + ["db2"])
                ms[alias, s, lo], ms[alias, s, hi] = a, b
                per_visit[alias, s] = per_visit[name, s]
    return {"launches": launches,
            "n": {s: tiles * TILE for s, (tiles, _) in shapes.items()},
            "ms": ms, "per_visit": per_visit,
            "plain_ms": {(m, s): plain_ms["dma" if _KERNEL_MODE[m] >= 2
                                          else "pure", s]
                         for m in MODES for s in shapes},
            "hits": {(m, s): int((outs[(m, (s, vs[0]))][1] >= 0).sum())
                     for m in MODES for s, (_, vs) in shapes.items()},
            "blocks_per_sm": blocks_per_sm()}


def b17(per_visit: dict, shape: str, prefix: str = "") -> dict:
    """The B-17 reading at ``shape`` from :func:`measure`'s ``per_visit``
    (``prefix``: whose, "" the kernel's): ns a visit of dma - pure (what
    K5's per-lane fetch costs) and dma - db (what the staged ring hides),
    each with its share of dma."""
    pv = lambda m: per_visit[prefix + m, shape]
    dma = pv("dma")
    return {"dma - pure": (dma - pv("pure"), (dma - pv("pure")) / dma),
            "dma - db": (dma - pv("db"), (dma - pv("db")) / dma)}


_SOURCE_CONSTANT = r"constexpr int {} = (-?\d+);"


def source_form(text: str) -> Optional[Tuple[int, bool]]:
    """(kLeafLanes, kBulk) of a source of the kernel in the warp's form,
    or None for another form (the first, a thread a ray)."""
    lanes = re.search(_SOURCE_CONSTANT.format("kLeafLanes"), text)
    bulk = re.search(_SOURCE_CONSTANT.format("kBulk"), text)
    if not (lanes and bulk):
        return None
    return int(lanes.group(1)), bool(int(bulk.group(1)))


def _count(code, span, prefix, wide=False) -> int:
    """The instructions of ``span`` whose opcode starts with ``prefix``
    (``wide``: and moves 128 bits)."""
    lo, hi = span
    return sum(opcode(i).startswith(prefix) and (not wide or ".128" in
                                                 opcode(i))
               for _, i in code[lo:hi + 1])


def mode_sass(text: str, lanes: int = LEAF_LANES, bulk: bool = True
              ) -> Dict[str, Tuple[float, int, int]]:
    """{mode: (slot, pass, visit)} of the leafmt kernels in a ``cuobjdump
    -sass`` dump (by the mangled name's template argument): the warp
    instructions of a slot test (the slot loop's, a MUFU.RCP a test), of a
    pass without its slot loop (the broadcasts, the (t, slot) merge and
    the owner's take) and of a visit without its passes (the db ring's
    copy and wait, the cond branch), each without the IEEE division's slow
    path. The slot loop is the innermost loop with a MUFU.RCP that a pass
    loop and a visit loop hold. Raises unless the slot loop is the
    ``lanes``-lane form (its rows read as 3 128-bit loads a test:
    ``LDS.128``, in dma ``LDG``; the pass's merge 2 log2(lanes)
    ``SHFL.BFLY``), and unless db's visit holds the bulk copy (``UBLKCP``)
    and the mbarrier wait (``SYNCS.PHASECHK``), or with ``bulk`` False
    the lanes' ``LDGSTS``."""
    out = {}
    for name, code in sass_functions(text).items():
        m = re.search(r"leafmt_kernelILi(\d)E", name)
        if not m:
            continue
        mode = MODES[int(m.group(1))]
        loops = body_loops(code)
        inside = lambda a, b: b[0] <= a[0] and a[1] <= b[1] and a != b
        around = lambda a: sorted((b for b in loops if inside(a, b)),
                                  key=lambda b: b[1] - b[0])
        slots = [s for s in loops if _count(code, s, "MUFU.RCP")
                 and len(around(s)) >= 2
                 and not any(inside(o, s) for o in loops)]
        if not slots:
            raise ValueError(f"{mode}: no slot loop inside a pass and a "
                             f"visit loop: not the {lanes}-lane form")
        slot = min(slots)
        pas, vis = around(slot)[:2]
        tests = _count(code, slot, "MUFU.RCP")
        load = "LDG" if mode == "dma" else "LDS"
        if _count(code, slot, load, wide=True) != 3 * tests:
            raise ValueError(f"{mode}: the slot loop reads its rows in "
                             f"{_count(code, slot, load, wide=True)} "
                             f"128-bit {load}, not {3 * tests}")
        bfly = _count(code, pas, "SHFL.BFLY")
        if bfly != 2 * int(math.log2(lanes)):
            raise ValueError(f"{mode}: {bfly} SHFL.BFLY a pass, not the "
                             f"{lanes}-lane merge's {2 * int(math.log2(lanes))}")
        if mode == "db":
            need = ("UBLKCP", "SYNCS.PHASECHK") if bulk else ("LDGSTS",)
            missing = [op for op in need if not _count(code, vis, op)]
            if missing:
                raise ValueError(f"db: the visit loop has no {missing}")
        n_slot, n_pass = fast_count(code, slot), fast_count(code, pas)
        out[mode] = (n_slot / tests, n_pass - n_slot,
                     fast_count(code, vis) - n_pass)
    return out


def issue_floor(sass: tuple, n: int, visits: int,
                lanes: int = LEAF_LANES) -> Tuple[float, int]:
    """(ms, warp instructions): the least time the card could issue a
    mode's SASS (``sass``: :func:`mode_sass`'s (slot, pass, visit)) for
    ``visits`` visits of ``n`` rays at ``common.ISSUE_RATE``: a warp's
    visit is 64 slot tests a lane, ``lanes`` passes and one visit's
    own."""
    slot, pas, vis = sass
    ins = n // 32 * visits * (WIDTH * slot + lanes * pas + vis)
    return ins / ISSUE_RATE * 1e3, int(ins)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    shapes = SHAPES
    if "--blocks" in argv:
        k = argv.index("--blocks")
        tiles = int(argv.pop(k + 1))
        argv.pop(k)
        shapes = {f"{tiles} tiles": (tiles, VISITS)}
    own = (_build.CSRC_DIR / "leafmt_probe.cu").read_text()
    texts, _, out = ab_sources(argv, own)
    texts.pop("new")
    dev = card("leafmt_probe")
    with ThreadPoolExecutor(max(1, len(texts))) as ex:
        built = dict(zip(texts, ex.map(lambda kv: source_lib(*kv, out),
                                       texts.items())))
    sources = {name: lib for name, (lib, _) in built.items()}
    for name, (_, ptxas) in built.items():
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
    dumps = {"new": (sass_dump(_build.build("leafmt_probe")), own)}
    if out is not None:
        dumps.update({name: ((out / f"leafmt_{name}.sass").read_text(), t)
                      for name, t in texts.items()})
    for name, (dump, text) in dumps.items():
        form = source_form(text)
        if form:
            print(f"[sass] {name}: (slot, pass, visit) "
                  f"{mode_sass(dump, *form)}", flush=True)
    r = measure(dev, shapes, sources=sources)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{CLUSTERS} clusters of {WIDTH}; blocks of 128 threads, a tile "
          f"8 blocks, {r['blocks_per_sm']} resident blocks an SM of "
          f"{sms} SMs; every mode and source bit-equal to its plain version "
          f"at both points of each shape; device time a call in a CUDA "
          f"graph, {ROUNDS} rounds in turns", flush=True)
    for s, (tiles, (lo, hi)) in shapes.items():
        n = r["n"][s]
        print(f" {s}: {n} rays ({tiles} tiles), V = {lo} and {hi}",
              flush=True)
        for name in (nm for nm, sh in r["per_visit"] if sh == s):
            per = r["per_visit"][name, s]
            m = name.rsplit(" ", 1)[-1]
            served = f"; {SERVED_BY[m]}'s kernel" if m in SERVED_BY else ""
            print(f"  {name:12s}: {per:10.1f} ns a visit ({per / WIDTH:8.2f} "
                  f"a slot, {per / WIDTH / n * 1e3:.4f} ps a ray-slot pair)  "
                  f"[t({lo}) {r['ms'][name, s, lo]:.3f} ms, t({hi}) "
                  f"{r['ms'][name, s, hi]:.3f} ms, plain t({lo}) "
                  f"{r['plain_ms'][m, s]:.3f} ms; {r['hits'][m, s]} rays "
                  f"hit{served}]", flush=True)
        for prefix in ["", *(f"{k} " for k in sources)]:
            if (prefix + "dma", s) in r["per_visit"]:
                read = b17(r["per_visit"], s, prefix)
                print(f"  B-17 {prefix or 'kernel '}: " + ", ".join(
                    f"{k} {v:.1f} ns a visit ({sh:.1%} of dma)"
                    for k, (v, sh) in read.items()), flush=True)


if __name__ == "__main__":
    main()
