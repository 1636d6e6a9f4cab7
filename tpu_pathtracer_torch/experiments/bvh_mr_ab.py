"""A/B of the packet walk's sources on the card (K12a nearest, K12b
any-hit): ``csrc/bvh_mr.cu`` against other sources of its C entry, on the
dragon-class knot's ray sets, in turns with K5/K6.

    git show <commit>:tpu_pathtracer_torch/csrc/bvh_mr.cu > <dir>/parent.cu
    python -m tpu_pathtracer_torch.experiments.bvh_mr_ab \\
        parent=<dir>/parent.cu [NAME=K:V,K:V ...] [--out DIR]

``NAME=PATH`` adds a source (the first one given is the baseline of the
factors); ``NAME=K:V,...`` adds a variant of ``csrc/bvh_mr.cu`` with its
``constexpr int K`` set to V (say ``w2=kWarpsPerPacket:2``). ``new`` is
``csrc/bvh_mr.cu`` as it stands. Each source is driven through its own C
entry ``bvh_mr_launch``, built with the package's nvcc flags
(``ops/_build.py``), its ptxas lines printed and, with ``--out``, its
``cuobjdump -sass`` kept, each kernel's instructions counted and, for a
source of the split form, the warp instructions of a slot test, a node
round and a leaf round's merge (``mr_sass``, the counts ``chip_smoke.py``'s
issue-rate floor reads from the package's build).

Before any is timed, every source is held on every ray set bit-equal to
the plain walk (``ops/cuda_bvh_mr.py`` ``_mr_walk_ref``: t, winners,
occlusion and the per-packet counters). The plain walk's rounds give the
per-packet distribution (``packet_walk``): node rounds, leaf rounds and
leaf visits a packet, their mean, median, 99th percentile and maximum,
and the share of all leaf visits in the widest 1% of packets. Then each
set's call is timed in a CUDA graph (device time a call), the sources and
K5 (nearest sets) or K6 (NEE sets) in turns, forward then backward,
ROUNDS rounds; the median is printed with its factor against the
baseline.

Ray sets on the dragon-class knot (``knot_zoo_scene(512, 512, nu=1664,
nv=262)``, 872k triangles, 64 a leaf; ``bvh_ab.fixed_sets``):
``chip_smoke.py`` phase 10's 131,072 primary rays (pixels across the
frame), their bounce-2 rays and NEE shadow rays; the frame's own shape,
the pool's 196,608 contiguous middle-row pixels as primary rays and their
NEE rays.
"""

from __future__ import annotations

import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments.bvh_ab import (DRAGON, DRAGON_MESH,
                                                     fixed_sets)
from tpu_pathtracer_torch.experiments.common import (ab_sources,
                                                      branch_target, build,
                                                      card, graph_rounds,
                                                      opcode, sass_counts,
                                                      sass_functions)
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh_mr as cmr

ROUNDS = 5
TAIL = 0.01  # the widest share of packets whose leaf visits are summed
_MODES = {"0": "nearest", "1": "any_hit"}  # mr_kernel's template argument


def load(lib: Path) -> ctypes.CDLL:
    """The library, with ``bvh_mr_launch``'s signature set as
    ``cuda_bvh_mr._lib`` sets it."""
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.bvh_mr_launch.argtypes = ([i] + [p] * 9 + [i, i, ctypes.c_float, i]
                                  + [p] * 5)
    dll.bvh_mr_launch.restype = ctypes.c_int
    return dll


def launch(dll: ctypes.CDLL, any_hit: bool, origin, direction, tmax,
           tabs: cb.HeapTables, t_min: float):
    """``cuda_bvh_mr._launch`` through ``dll``'s C entry: (t, tri,
    counters) or (occ, counters), as ``_mr_walk_ref``'s outputs."""
    n = origin.x.shape[0]
    dev = origin.x.device
    cnt = torch.empty((3, (n + cmr.LANES - 1) // cmr.LANES),
                      dtype=torch.int32, device=dev)
    t_out = tri_out = occ_out = None
    if any_hit:
        occ_out = torch.empty((n,), dtype=torch.bool, device=dev)
    else:
        t_out = torch.empty((n,), dtype=torch.float32, device=dev)
        tri_out = torch.empty((n,), dtype=torch.int32, device=dev)
    ptr = lambda a: None if a is None else a.data_ptr()
    rc = dll.bvh_mr_launch(
        int(any_hit), *(a.data_ptr() for a in (*origin, *direction, tmax)),
        tabs.nodes.data_ptr(), tabs.tri.data_ptr(), tabs.first_leaf,
        tabs.prims_per_leaf, float(t_min), n, ptr(t_out), ptr(tri_out),
        ptr(occ_out), cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bvh_mr_launch failed: CUDA error {rc}")
    return (occ_out, cnt) if any_hit else (t_out, tri_out, cnt)


def packet_walk(origin, direction, tmax, tabs, t_min, any_hit, visits=None):
    """The plain walk (``_mr_walk_ref``; ``visits`` as it takes them) and
    its rounds a packet: (t, tri, occ, counters, node rounds [P] int64,
    leaf rounds [P] int64). A node round is a step at an interior node
    (entering two, one or no child); a leaf round tests the packet's
    queued leaves."""
    n_pk = (origin.x.shape[0] + cmr.LANES - 1) // cmr.LANES
    rounds = {k: torch.zeros(n_pk, dtype=torch.int64, device=tmax.device)
              for k in ("_node_round", "_leaf_round")}

    def counted(name):
        real = getattr(cmr, name)

        def fn(*a):
            rounds[name][a[-2]] += 1  # both take (..., packets, visits)
            return real(*a)
        return fn

    with mock.patch.object(cmr, "_node_round", counted("_node_round")), \
            mock.patch.object(cmr, "_leaf_round", counted("_leaf_round")):
        out = cmr._mr_walk_ref(origin, direction, tmax, tabs, t_min,
                               any_hit, visits)
    return (*out, rounds["_node_round"], rounds["_leaf_round"])


def distribution(x: torch.Tensor) -> dict:
    """mean, median, p99 and max of a per-packet count."""
    x = x.double()
    return {"mean": x.mean().item(), "median": x.median().item(),
            "p99": torch.quantile(x, 0.99).item(), "max": x.max().item()}


def tail_share(leaf_visits: torch.Tensor, share: float = TAIL) -> float:
    """The share of all leaf visits that the widest ``share`` of the
    packets (by leaf visits, at least one packet) make."""
    x = leaf_visits.to(torch.int64).sort(descending=True).values
    k = max(1, int(round(share * x.numel())))
    return x[:k].sum().item() / max(1, x.sum().item())


def describe(cnt, node_rounds, leaf_rounds) -> str:
    """A line of the per-packet distribution."""
    fmt = lambda d: " / ".join(f"{d[k]:.1f}" for k in
                               ("mean", "median", "p99", "max"))
    return (f"per packet (mean / median / p99 / max): node rounds "
            f"{fmt(distribution(node_rounds))}, leaf rounds "
            f"{fmt(distribution(leaf_rounds))}, leaf visits "
            f"{fmt(distribution(cnt[2]))}; the widest {TAIL:.0%} of the "
            f"packets make {tail_share(cnt[2]):.1%} of the leaf visits")


ISSUE_RATE = 528 * 1.98e9  # warp instructions a second: 132 SMs x 4
# schedulers at 1,980 MHz, one instruction a scheduler a cycle


def _slot(code, ops) -> float:
    """Warp instructions a slot test: the slot loop (of the innermost
    backward branches around a MUFU.RCP, the one with the most, then the
    shortest) over its MUFU.RCPs, less the division's slow path (what a
    forward branch inside the loop jumps over to skip a CALL)."""
    addr = [a for a, _ in code]
    rcp = [k for k, o in enumerate(ops) if o.startswith("MUFU.RCP")]
    spans = []
    for k, (a, ins) in enumerate(code):
        t = branch_target(ins)
        if t is not None and t <= a and t in addr:
            h = addr.index(t)
            if any(h <= j <= k for j in rcp):
                spans.append((h, k))
    inner = [(h, b) for h, b in spans
             if not any(h <= h2 and b2 <= b and (h2, b2) != (h, b)
                        for h2, b2 in spans)]
    loops = [(-sum(h <= j <= b for j in rcp), b - h, h, b)
             for h, b in inner]
    if not loops:
        raise ValueError("no loop around a MUFU.RCP")
    n, _, h, b = min(loops)
    slow = set()
    for k in range(h, b + 1):
        t = branch_target(code[k][1])
        if t is None or t <= code[k][0] or t not in addr:
            continue
        end = addr.index(t)
        if end <= b + 1 and any(o.startswith("CALL") for o in ops[k + 1:end]):
            slow.update(range(k + 1, end))
    return (b + 1 - h - len(slow)) / -n


def _node(ops) -> int:
    """Warp instructions of a node round's core: from the node rows' first
    128-bit load to the end of the votes (the run of VOTE.ANY after it)."""
    first = next(k for k, o in enumerate(ops)
                 if o.startswith("LDG.E.128"))
    vote = next(k for k in range(first, len(ops))
                if ops[k].startswith("VOTE.ANY"))
    while vote + 1 < len(ops) and ops[vote + 1].startswith("VOTE.ANY"):
        vote += 1
    return vote + 1 - first


def _merge(ops) -> int:
    """Warp instructions of a leaf round's merge: from the first of the
    stores before the last barrier that follows them within 4
    instructions (warp 0's merge barrier) to the first BSYNC after it."""
    bar = [k for k, o in enumerate(ops) if o.startswith("BAR.SYNC")
           and any(x.startswith("STS") for x in ops[max(0, k - 4):k])][-1]
    first = next(k for k in range(max(0, bar - 8), bar)
                 if ops[k].startswith("STS"))
    end = next(k for k in range(bar, len(ops)) if ops[k].startswith("BSYNC"))
    return end + 1 - first


def mr_sass(text: str) -> dict:
    """{mode: (slot, node, merge)} of ``csrc/bvh_mr.cu``'s split walk in a
    ``cuobjdump -sass`` dump of its build (the kernels by the mangled
    name's template argument): the warp instructions of a slot test
    (``_slot``), of a node round's loads, slab tests and votes (``_node``)
    and of a leaf round's merge by each warp (``_merge``). Raises if the
    dump holds another form (the parent's has no merge barrier)."""
    out = {}
    for name, code in sass_functions(text).items():
        m = re.search(r"mr_kernelILi(\d)E", name)
        mode = _MODES.get(m.group(1) if m else "")
        if mode is None:
            continue
        ops = [opcode(i) for _, i in code]
        try:
            out[mode] = (_slot(code, ops), _node(ops), _merge(ops))
        except (StopIteration, IndexError, ValueError) as e:
            raise ValueError(f"{name}: not the split walk ({e})") from e
    if set(out) != set(_MODES.values()):
        raise ValueError(f"the dump holds the split walks of {sorted(out)}")
    return out


def warps_per_packet(text: str) -> int:
    """kWarpsPerPacket of a ``csrc/bvh_mr.cu`` source (1: the parent's
    one warp a packet)."""
    m = re.search(r"constexpr int kWarpsPerPacket = (\d+);", text)
    return int(m.group(1)) if m else 1


def issue_floor(sass, P, W, node_rounds, leaf_rounds, leaf_visits):
    """(ms, warp instructions): the least time the card could issue the
    split walk's SASS (``sass``: a mode's (slot, node, merge)) for a
    run's rounds at ISSUE_RATE: every slot of every leaf visit tested
    once (by one of the W warps, for its 32 lanes), each node round by
    warp 0, each leaf round's merge by all W."""
    slot, node, merge = sass
    ins = (slot * P * int(leaf_visits.sum(dtype=torch.int64))
           + node * int(node_rounds.sum())
           + merge * W * int(leaf_rounds.sum()))
    return ins / ISSUE_RATE * 1e3, int(ins)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = card("bvh_mr_ab")
    texts, _, out = ab_sources(argv,
                               (_build.CSRC_DIR / "bvh_mr.cu").read_text())
    with ThreadPoolExecutor(len(texts)) as ex:
        built = dict(zip(texts, ex.map(
            lambda kv: build(f"mr_{kv[0]}", kv[1], out), texts.items())))
    libs, counts = {}, {}
    for name, (lib, ptxas) in built.items():
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
        libs[name] = load(lib)
        if out is not None:
            dump = (out / f"mr_{name}.sass").read_text()
            for fn_name, (n_all,) in sass_counts(dump, ops=()).items():
                print(f"[sass] {name} {fn_name}: {n_all} instructions",
                      flush=True)
            try:
                counts[name] = mr_sass(dump)
                got = counts[name]
            except ValueError as e:
                got = f"not counted ({e})"
            print(f"[sass] {name} (slot, node round, merge): {got}",
                  flush=True)

    cfg = RenderConfig(**DRAGON)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, device=dev, **DRAGON_MESH)
    tabs = cb.heap_tables(scene.mesh)
    eps = cfg.epsilon
    sets = fixed_sets(scene, cam, cfg)
    ref, rounds = {}, {}
    for sname, (any_hit, o, d, tm) in sets.items():
        t, tri, occ, cnt, nodes, leaves = packet_walk(o, d, tm, tabs, eps,
                                                      any_hit)
        ref[sname] = (occ, cnt) if any_hit else (t, tri, cnt)
        rounds[sname] = (nodes, leaves, cnt[2])
        print(f"[set] {sname}: {o.x.shape[0]} lanes, "
              f"{int((tm > 0).sum())} live, {cnt.shape[1]} packets; "
              + describe(cnt, nodes, leaves), flush=True)

    for name, dll in libs.items():
        for sname, (any_hit, o, d, tm) in sets.items():
            got = launch(dll, any_hit, o, d, tm, tabs, eps)
            if not all(torch.equal(a, b) for a, b in zip(got, ref[sname])):
                raise AssertionError(f"{name} differs from the plain walk "
                                     f"on {sname}")
        print(f"[check] {name}: bit-equal to the plain walk (t, winners, "
              f"occlusion, counters) on {len(sets)} sets", flush=True)

    def call(name, sname):
        any_hit, o, d, tm = sets[sname]
        if name == "K5":
            return (cb.heap_occluded if any_hit else cb.heap_trace)(
                o, d, tm, tabs, eps)
        return launch(libs[name], any_hit, o, d, tm, tabs, eps)

    order = list(libs) + ["K5"]
    times = graph_rounds(order, list(sets), call, ROUNDS)
    for sname, (any_hit, *_) in sets.items():
        b = times[order[0], sname]
        row = [f"{('K6' if any_hit else 'K5') if name == 'K5' else name} "
               f"{times[name, sname]:.4f} ({b / times[name, sname]:.2f}x)"
               for name in order]
        print(f"[time] {sname}, ms a call in a CUDA graph, median of "
              f"{ROUNDS}: " + "; ".join(row), flush=True)
        for name, sass in counts.items():
            ms, ins = issue_floor(sass["any_hit" if any_hit else "nearest"],
                                  tabs.prims_per_leaf,
                                  warps_per_packet(texts[name]),
                                  *rounds[sname])
            print(f"[floor] {sname} {name}: issue-rate floor {ms:.4f} ms "
                  f"({ins} warp instructions), "
                  f"{ms / times[name, sname]:.1%} of its time", flush=True)


if __name__ == "__main__":
    main()
