"""The regrouped (demand-packed) leaf phase alone, one window at a time
(K21): the CUDA kernel ``csrc/regroup_probe.cu``, its plain PyTorch
version, and the probe that prices K11's leaf-major flush per (ray, leaf)
pair. The port's counterpart of ``experiments/regroup_probe.py``
(``_kernel``, through ``run_window``).

    python -m tpu_pathtracer_torch.experiments.regroup_probe [upto ...] \\
        [parent=FILE.cu] [NAME=K:V,...] [--out DIR]

A window is K = 64 leaf visits, each with a demand mask over the R = 1024
rays of an (8, 128) tile, packed into S = 1024 (ray, visit) pair slots.
Slot s belongs to the last visit v with ``vpref[v] <= s`` (``vpref`` the
exclusive cumsum of the per-visit demand counts, so a visit with no demand
shares its ``vpref`` with the next and the later one wins) and to the ray
whose exclusive rank in flat (row * 128 + lane) order among visit v's
demanding rays is ``k = s - vpref[v]``. Slots at or past ``vpref[64]`` are
unused: they still take v = 63, k = s - ``vpref[63]``. Each slot tests its
ray against its visit's 64-triangle cluster (Moller-Trumbore, ``cl0`` the
cap); each ray keeps the least t over its slots, the earliest slot on a
tie, the first triangle within a slot. ``upto`` stops early and writes the
TPU kernel's diagnostic outputs (:func:`regroup_window`).

The TPU kernel fetches rays and triangles by one-hot bf16 products on its
MXU (3-term splits, exact). The split reconstructs a normal float32
exactly (``hi + mid + lo == x``; :func:`bf16_split`), so the port reads
the float32 values. A block of 1024 threads computes a window: it ranks
each visit's demand with ``__ballot_sync``, scatters the rays into their
slots in shared memory, stages the window's clusters in shared memory by
the bulk-copy engine (one ``cp.async.bulk`` a visit on a ring of
mbarriers, the first half issued before the ranking), tests each slot on
4 lanes with the rows read as shared-memory broadcasts, and merges each
ray's winner in slot order with no atomic (``csrc/regroup_probe.cu``
says how). ``vpref``
and ``cids`` are the TPU's SMEM scalars: host tensors here, passed to the
kernel by value.

:func:`regroup_window` dispatches on the device of its rays: CPU tensors go
to the plain version, CUDA tensors to the kernel or the call raises.
``main()`` runs :func:`measure`: every mode held bit-equal to its plain
version on one window, on the TPU file's two repeat counts (4 and 1028
windows, repeated inside one block: one SM) and card-wide (one window on
each of 132 x 8 blocks), then timed in turns there, device time a call in
a CUDA graph; the slope gives us a window on one SM and ns a pair, the
card-wide call ns a pair across the card. Beside each mode stand its bound
(:func:`bound`) and the issue-rate floor of the build's SASS
(:func:`mode_sass`, :func:`issue_floor`). ``parent=FILE.cu`` (say the
first form, a thread a slot with a 64-bit ``atomicMin`` a ray: commit
5c72a46's ``csrc/regroup_probe.cu`` saved under a gitignored directory;
any other name too, such as a yardstick that reads the rows per lane)
and ``NAME=K:V,...`` (this source with its ``constexpr int K`` set to V:
``l8=kSlotLanes:8``, ``r8=kRingStages:8``, ``nofence=kProxyFence:0``)
add sources with the same C entry, held bit-equal and timed in turns
with the package's kernel; ``--out DIR`` keeps each build's ptxas lines
and SASS.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
import math
import re
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.experiments.common import (ISSUE_RATE, ab_sources,
                                                     body_loops, build, card,
                                                     fast_count,
                                                     graph_rounds, median_ms,
                                                     opcode, roofline,
                                                     sass_dump,
                                                     package_ptxas,
                                                     sass_functions,
                                                     split_ab)
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops.cuda_spheres import _check

S = 1024          # pair slots a window
K = 64            # leaf visits a window
W = 64            # triangles a cluster
R = 1024          # rays a packet: the (8, 128) tile
COMPS = 16        # words a triangle in a cluster row (12 used)
FLT_MAX = float(np.finfo(np.float32).max)
T_MIN = 1e-3
BIG = 1 << 30     # the TPU kernel's "no slot" besti (float 2^30)
UPTOS = ("ct", "g", "ray", "tri", "mt", "full")
STAGED = ("tri", "mt", "full")  # the modes that stage the clusters
WINDOWS = (4, 1028)     # the TPU file's repeat counts (:307-308)
# the card-wide reading: one window a block, 8 waves of 132 at the staged
# form's one block an SM (the first form's count, so ns a pair compares)
CARD_BLOCKS = 132 * 8
CELLS = ((WINDOWS[0], 1), (WINDOWS[1], 1), (1, CARD_BLOCKS))  # (windows, blocks)
# Kernel launches by regroup_window, per mode. Callers reset them to 0 and
# read them back to show that a run went through the kernel.
LAUNCHES = {u: 0 for u in UPTOS}
ROUNDS = 3
CALLS = 2  # calls a CUDA graph: a 1028-window call takes milliseconds
WARPS = 32  # a block's warps
SM_ISSUE_RATE = ISSUE_RATE / 132  # one SM's 4 schedulers
# the FP32 operations a slot (compares and integer steps not counted):
# ct's add, ray's 3 sums and 2 more, tri's 8 products and 8 sums (a used
# slot); mt/full take MT_FLOPS a slot-triangle over the pairs
SLOT_FLOPS = {"ct": 1, "g": 0, "ray": 5, "tri": 16}
MT_FLOPS = 37
CLUSTER_BYTES = 12 * W * 4  # the 12 used words of a triangle, a cluster
OUT_BYTES = 8 * R  # a block's t_out and i_out


def make_arrays(rng: np.random.Generator, pairs_target: int = 840):
    """The TPU file's ``make_inputs`` (:241-265) without its bf16 split:
    (rays (7, 8, 128) f32 = ox, oy, oz, dx, dy, dz, cl0 = 8; masks (64, 8,
    128) f32; vpref (65,) int32; cids (64,) int32; tri (64, 1024) f32,
    comp-major: word c * 64 + w is component c of triangle w, c = 0-2 v0,
    3-5 e1, 6-8 e2, 9-11 n, 12-15 unused), drawn in its order."""
    o = rng.uniform(-1, 1, (3, 8, 128)).astype(np.float32)
    d = rng.uniform(-1, 1, (3, 8, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    cl0 = np.full((1, 8, 128), 8.0, np.float32)
    p = pairs_target / (K * R)
    m = (rng.uniform(size=(K, 8, 128)) < p).astype(np.float32)
    counts = m.reshape(K, -1).sum(1).astype(np.int64)
    vpref = np.zeros(K + 1, np.int32)
    vpref[1:] = np.cumsum(counts)
    assert vpref[-1] <= S, vpref[-1]
    cids = rng.integers(0, 13000, K).astype(np.int32)
    tri = rng.uniform(-1.5, 1.5, (K, COMPS * W)).astype(np.float32)
    return np.concatenate([o, d, cl0]), m, vpref, cids, tri


def probe_inputs(device="cuda", seed: int = 7) -> Dict[str, torch.Tensor]:
    """The TPU file's inputs from its seed (``default_rng(7)``): rays,
    masks and tri on ``device``; vpref and cids on the host (the kernel's
    scalar operands)."""
    rays, m, vpref, cids, tri = make_arrays(np.random.default_rng(seed))
    dev = lambda a: torch.from_numpy(a).to(device)
    return {"rays": dev(rays), "masks": dev(m), "tri": dev(tri),
            "vpref": torch.from_numpy(vpref), "cids": torch.from_numpy(cids)}


def bf16_split(x: torch.Tensor):
    """The TPU file's 3-term bf16 split (``split3`` :57): (hi, mid, lo),
    bf16, with hi + mid + lo == x for normal float32 values."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


# -------------------------------------------------------- plain version
def slot_table(vpref, masks: torch.Tensor):
    """(v_of [S], k [S], used [S], slot_ray [S], -1 for none): each slot's
    visit, rank and ray, from ``vpref`` (a list) and the demand masks."""
    dev = masks.device
    s = torch.arange(S, device=dev)
    v_of = torch.zeros(S, dtype=torch.int64, device=dev)
    for v in range(K):
        v_of = torch.where(s >= vpref[v], v, v_of)
    vp = torch.tensor(vpref, dtype=torch.int64, device=dev)
    k = s - vp[v_of]
    used = s < vpref[K]
    mm = masks.reshape(K, R) > 0.5
    rank = torch.cumsum(mm.to(torch.int64), 1) - mm.to(torch.int64)
    v_idx, r_idx = mm.nonzero(as_tuple=True)
    slot = vp[v_idx] + rank[v_idx, r_idx]
    ok = (slot < min(S, vpref[K])) & (v_of[slot.clamp(max=S - 1)] == v_idx)
    slot_ray = torch.full((S,), -1, dtype=torch.int64, device=dev)
    slot_ray[slot[ok]] = r_idx[ok]
    return v_of, k, used, slot_ray


def _regroup_ref(rays: torch.Tensor, masks: torch.Tensor, tri: torch.Tensor,
                 vpref: torch.Tensor, cids: torch.Tensor, upto: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One window of ``_kernel`` at ``upto``: (t_out (8, 128) f32, i_out
    (8, 128) int32), as the TPU kernel's ``if upto == ...`` blocks write
    them (:134-226): indexed by slot (ct, ray, tri, mt; g's i_out) or by
    ray (g's t_out, full)."""
    vp, cid = vpref.tolist(), cids.to(torch.int64).to(rays.device)
    v_of, k, used, slot_ray = slot_table(vp, masks)
    cid_s = cid[v_of]
    shape = (8, 128)
    i32 = torch.int32
    if upto == "ct":
        t = cid_s.float() + k.float()
        return t.reshape(shape), torch.where(used, v_of, -1).to(i32).reshape(
            shape)
    if upto == "g":
        owned = torch.zeros(R, dtype=torch.int64, device=rays.device)
        has = slot_ray >= 0
        owned.index_add_(0, slot_ray[has], torch.ones_like(slot_ray[has]))
        return owned.float().reshape(shape), used.to(i32).reshape(shape)
    flat = rays.reshape(7, R)
    has = slot_ray >= 0
    x = torch.where(has, flat[:, slot_ray.clamp(min=0)], 0.0)  # [7, S]
    o1, o2, o3, d1, d2, d3, clp = x
    if upto == "ray":
        return (((o1 + o2) + o3) + clp).reshape(shape), \
            ((d1 + d2) + d3).to(i32).reshape(shape)
    cl = tri.reshape(K, COMPS, W)[v_of]                    # [S, 16, W]
    if upto == "tri":
        t = torch.zeros(S, dtype=torch.float32, device=rays.device)
        for w in range(8):
            t = t + cl[:, 0, w] * 0.5
        return torch.where(used, t, 0.0).reshape(shape), \
            torch.zeros(shape, dtype=i32, device=rays.device)
    rows = cl[:, :12, :].transpose(1, 2)                    # [S, W, 12]
    t, ok = cb.mt_rows(rows, torch.stack([o1, o2, o3], 1),
                       torch.stack([d1, d2, d3], 1), T_MIN, clp)
    tw = torch.where(ok, t, FLT_MAX)
    t_slot = tw.min(dim=1).values
    w_slot = (tw == t_slot[:, None]).to(torch.uint8).argmax(dim=1)
    besti = cid_s * W + w_slot
    if upto == "mt":
        return t_slot.reshape(shape), besti.to(i32).reshape(shape)
    # full: per ray the least (t bits, slot) over its slots
    key = (t_slot.view(torch.int32).to(torch.int64) << 10) | torch.arange(
        S, device=rays.device)
    best = torch.full((R,), 2 ** 62, dtype=torch.int64, device=rays.device)
    best.scatter_reduce_(0, slot_ray[has], key[has], "amin")
    any_slot = best < 2 ** 62
    minv = torch.where(any_slot, (best >> 10).to(torch.int32).view(
        torch.float32), FLT_MAX)
    minb = torch.where(any_slot, besti[best & (S - 1)], BIG)
    clc = flat[6]
    hit = minv < clc
    return torch.where(hit, minv, clc).reshape(shape), \
        torch.where(hit, minb, -1).to(i32).reshape(shape)


def _regroup_plain(inp, upto, windows=1, blocks=1):
    """The plain version of ``windows`` windows on ``blocks`` blocks: the
    window computed ``windows`` times, its outputs repeated a block."""
    for _ in range(max(windows, 1)):
        t, i = _regroup_ref(inp["rays"], inp["masks"], inp["tri"],
                            inp["vpref"], inp["cids"], upto)
    return t.repeat(blocks, 1, 1), i.repeat(blocks, 1, 1)


# --------------------------------------------------------------- wrapper
def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (the package's build or another source's) with
    ``regroup_probe_launch``'s signature set."""
    fn = lib.regroup_probe_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return bind(_build.load("regroup_probe"))


def source_lib(name: str, text: str, out: Optional[Path] = None):
    """(library, ptxas lines) of another source of the kernel with the same
    C entry (a parent, a variant), built by ``common.build`` as
    ``regroup_<name>`` and bound; ``out`` keeps its ptxas lines and SASS."""
    lib, ptxas = build(f"regroup_{name}", text, out)
    return bind(ctypes.CDLL(str(lib))), ptxas


def ring_bytes() -> int:
    """The dynamic shared memory a staged mode's block takes: its ring."""
    return _lib().regroup_probe_ring_bytes()


def _scalars(vpref: torch.Tensor, cids: torch.Tensor) -> None:
    """Raise unless vpref (65,) and cids (64,) are host int32 with
    vpref[0] = 0, vpref nondecreasing and vpref[64] <= S."""
    for name, a, n in (("vpref", vpref, K + 1), ("cids", cids, K)):
        _check(name, a, torch.device("cpu"), torch.int32, (n,))
    vp = vpref.tolist()
    if vp[0] != 0 or any(b < a for a, b in zip(vp, vp[1:])):
        raise ValueError("vpref must start at 0 and never decrease")
    if vp[K] > S:
        raise ValueError(f"vpref[{K}] = {vp[K]} pairs exceed the {S} slots")


def _launch(inp: Dict[str, torch.Tensor], upto: str, windows: int,
            blocks: int, lib: Optional[ctypes.CDLL] = None):
    """One launch through ``lib`` (default: the package's build, counted
    in LAUNCHES; another library's launches are not counted)."""
    rays, masks, tri = inp["rays"], inp["masks"], inp["tri"]
    dev = rays.device
    _check("rays", rays, dev, torch.float32, (7, 8, 128))
    _check("masks", masks, dev, torch.float32, (K, 8, 128))
    _check("tri", tri, dev, torch.float32, (K, COMPS * W))
    if tri.data_ptr() % 16:
        raise ValueError("tri must be 16-byte aligned (the bulk copy's)")
    _scalars(inp["vpref"], inp["cids"])
    t = torch.empty((blocks, 8, 128), dtype=torch.float32, device=dev)
    i = torch.empty((blocks, 8, 128), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = (lib or _lib()).regroup_probe_launch(
            UPTOS.index(upto), rays.data_ptr(), masks.data_ptr(),
            tri.data_ptr(), inp["vpref"].data_ptr(), inp["cids"].data_ptr(),
            int(windows), int(blocks), t.data_ptr(), i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"regroup_probe kernel launch failed: CUDA error "
                           f"{rc}")
    if lib is None:
        LAUNCHES[upto] += 1
    return t, i


def regroup_window(inp: Dict[str, torch.Tensor], upto: str = "full",
                   windows: int = 1, blocks: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``windows`` repeats of the window ``inp`` (:func:`probe_inputs`'s
    keys) at ``upto`` on each of ``blocks`` blocks: (t_out [blocks, 8, 128]
    f32, i_out [blocks, 8, 128] int32)."""
    if upto not in UPTOS:
        raise ValueError(f"upto must be one of {UPTOS}, not {upto!r}")
    if windows < 1 or blocks < 1:
        raise ValueError("windows and blocks must be >= 1")
    dev = inp["rays"].device
    if dev.type == "cpu":
        return _regroup_plain(inp, upto, windows, blocks)
    if dev.type != "cuda":
        raise ValueError(f"no regroup kernel for tensors on {dev}")
    return _launch(inp, upto, windows, blocks)


# ------------------------------------------------------ bound and floor
def work(upto: str, pairs: int) -> Tuple[int, int]:
    """(FP32 operations of one window at ``upto``, bytes of the inputs its
    outputs depend on: ct none; g the masks; ray the masks and rays; tri
    its 8 words of each cluster; mt and full the masks, rays and the 12
    used words of each cluster)."""
    masks, rays = 4 * K * R, 4 * 7 * R
    nbytes = {"ct": 0, "g": masks, "ray": masks + rays,
              "tri": 4 * 8 * K}.get(upto, masks + rays + K * CLUSTER_BYTES)
    flops = (MT_FLOPS * W * pairs if upto in ("mt", "full") else
             SLOT_FLOPS[upto] * (pairs if upto == "tri" else S))
    return flops, nbytes


def bound(upto: str, pairs: int, windows: int, blocks: int = 1
          ) -> Tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``windows`` windows at ``upto`` on each of ``blocks`` blocks
    (:func:`work`): the window's FP32 operations every time, its distinct
    inputs read once (every window and block computes the same window,
    so a repeat re-reads what the L2 or L1 holds), and each block's
    OUT_BYTES written once."""
    flops, nbytes = work(upto, pairs)
    return roofline(flops * windows * blocks, nbytes + OUT_BYTES * blocks)


SOURCE_CONSTANT = r"constexpr int {} = (-?\d+);"


def source_lanes(text: str) -> Optional[int]:
    """kSlotLanes of a source of the kernel in the staged form, or None
    for another form (the first, a thread a slot)."""
    lanes = re.search(SOURCE_CONSTANT.format("kSlotLanes"), text)
    return int(lanes.group(1)) if lanes else None


def mode_sass(text: str) -> Dict[str, Tuple[float, int, float, int]]:
    """{mode: (test, step, rank, rest)} of the regroup kernels in a
    ``cuobjdump -sass`` dump (by the mangled name's template argument),
    warp instructions without the IEEE division's slow path: ``test`` a
    triangle test of a lane (the tests' loop over its MUFU.RCPs; mt,
    full), ``step`` a warp step's own (the loop around the tests, less
    them: the slot's ray and rows, the ring's waits and releases, the
    lanes' merge; tri: the 8-word sum), ``rank`` a visit's ranking (the
    ballot loop over its VOTE.ANYs; 0 in ct) and ``rest`` a warp's window
    outside those loops (the scalars, the search, the scan, one pass of
    the scatter and the ray's merge over its demand bits, the outputs),
    each counted once. Where the compiler unrolls a step's tests into the
    step loop (32 lanes a slot: 2 tests a lane), ``test`` is the step
    loop over its MUFU.RCPs and ``step`` 0, which floors the same. Raises
    on a shared-memory atomic (the first form's 64-bit atomicMin) and
    unless a staged mode holds the bulk copy (UBLKCP) and the mbarrier
    wait (SYNCS)."""
    out = {}
    for name, code in sass_functions(text).items():
        m = re.search(r"regroup_kernelILi(\d)E", name)
        if not m:
            continue
        mode = UPTOS[int(m.group(1))]
        ops = [opcode(i) for _, i in code]
        atoms = sorted({o for o in ops if o.startswith("ATOMS")})
        if atoms:
            raise ValueError(f"{mode}: shared-memory atomics {atoms}")
        if mode in STAGED:
            missing = [op for op in ("UBLKCP", "SYNCS")
                       if not any(o.startswith(op) for o in ops)]
            if missing:
                raise ValueError(f"{mode}: no {missing} in the SASS")
        loops = body_loops(code)
        has = lambda span, pred: sum(
            pred(opcode(i), i) for _, i in code[span[0]:span[1] + 1])
        window = max(loops, key=lambda x: x[1] - x[0])
        inner = lambda pred: sorted(
            (x for x in loops if x != window and window[0] <= x[0]
             and x[1] <= window[1] and has(x, pred)),
            key=lambda x: x[1] - x[0])
        vote = lambda o, i: o.startswith("VOTE.ANY")
        ranks = inner(vote)
        n_rank = fast_count(code, ranks[0]) if ranks else 0
        rank = n_rank / has(ranks[0], vote) if ranks else 0.0
        rest = fast_count(code, window) - n_rank
        test = step = 0
        if mode in STAGED:
            mufu = lambda o, i: o.startswith("MUFU.RCP")
            work_op = (mufu if mode != "tri" else
                       lambda o, i: o.startswith("FMUL") and "0.5" in i)
            spans = inner(work_op)
            if not spans:
                raise ValueError(f"{mode}: no step loop")
            steps = spans[0]
            n_step = fast_count(code, steps)
            rest -= n_step
            if mode == "tri":
                step = n_step
            else:
                around = [x for x in spans[1:] if x[0] <= steps[0]
                          and steps[1] <= x[1]]
                if around:  # the tests' loop inside the step loop
                    tests, steps = steps, around[0]
                    n_test = fast_count(code, tests)
                    rest -= fast_count(code, steps) - n_step
                    step = fast_count(code, steps) - n_test
                    test = n_test / has(tests, mufu)
                else:
                    test = n_step / has(steps, mufu)
        out[mode] = (test, step, rank, rest)
    return out


def issue_floor(sass: tuple, pairs: int, windows: int, lanes: int,
                rate: float = ISSUE_RATE) -> float:
    """ms: the least time the card (or one SM, ``rate`` SM_ISSUE_RATE)
    could issue ``windows`` windows of a mode's SASS (:func:`mode_sass`'s
    (test, step, rank, rest)) at ``lanes`` lanes a slot: every warp's rank
    of 64 visits and its rest, and the window's warp steps (32 / lanes
    slots each over the ``pairs`` used slots), each with its 64 / lanes
    tests a lane."""
    test, step, rank, rest = sass
    steps = math.ceil(pairs / (32 // lanes))
    per = WARPS * (K * rank + rest) + steps * (step + W // lanes * test)
    return windows * per / rate * 1e3


# ------------------------------------------------------------ measurement
def measure(inp: Dict[str, torch.Tensor], uptos=UPTOS,
            rounds: int = ROUNDS,
            sources: Optional[Dict[str, ctypes.CDLL]] = None) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 17 print it). Every mode of ``uptos`` runs on
    one window, at both repeat counts (WINDOWS, one block) and card-wide
    (one window on each of CARD_BLOCKS blocks), each held bit-equal to its
    plain version, as is each of ``sources`` ({name: library with the same
    C entry}, not counted in LAUNCHES); then every mode of each is timed
    in turns at those three cells, device time a call in a CUDA graph
    (``common.graph_rounds``, ``rounds`` rounds). Returns ``launches``
    (LAUNCHES after the package's checked runs), ``pairs``, ``hits`` (rays
    with a winner, full) and ``modes``: by mode (the package's) or
    "<source> <mode>": ``t`` ((ms at 4, ms at 1028 windows)), ``card_ms``
    (the card-wide call), ``us_window`` (the slope: one SM), ``ns_pair``
    (the slope over the pairs), ``card_ns_pair`` (the card-wide call over
    its windows' pairs) and, for the package's, ``plain_ms`` (the plain
    version at 4 windows)."""
    lo, hi = WINDOWS
    sources = sources or {}
    libs = {"": None, **{f"{name} ": lib for name, lib in sources.items()}}
    for u in uptos:
        want = _regroup_plain(inp, u)
        for prefix, lib in libs.items():
            for w, b in ((1, 1), *CELLS):
                got = (regroup_window(inp, u, w, b) if lib is None else
                       _launch(inp, u, w, b, lib))
                torch.cuda.synchronize()
                if not all(torch.equal(g, p.repeat(b, 1, 1))
                           for g, p in zip(got, want)):
                    raise AssertionError(
                        f"{prefix}regroup {u} at {w} window(s) on {b} "
                        f"block(s): kernel != plain on "
                        f"{int((got[0] != want[0]).sum())} t, "
                        f"{int((got[1] != want[1]).sum())} i")
    launches = dict(LAUNCHES)
    pairs = int(inp["vpref"][K])
    out = {"launches": launches, "pairs": pairs, "modes": {},
           "hits": int((regroup_window(inp, "full")[1] >= 0).sum())}
    names = [(prefix, u) for prefix in libs for u in uptos]
    times = graph_rounds(names, list(CELLS),
                         lambda n, c: _launch(inp, n[1], *c, libs[n[0]]),
                         rounds, calls=CALLS)
    for prefix, u in names:
        t = (times[(prefix, u), CELLS[0]], times[(prefix, u), CELLS[1]])
        card_ms = times[(prefix, u), CELLS[2]]
        per = (t[1] - t[0]) / (hi - lo)
        out["modes"][prefix + u] = {
            "t": t, "card_ms": card_ms, "us_window": per * 1e3,
            "ns_pair": per * 1e6 / max(pairs, 1),
            "card_ns_pair": card_ms * 1e6 / CARD_BLOCKS / max(pairs, 1)}
    for u in uptos:
        out["modes"][u]["plain_ms"] = median_ms(
            lambda u=u: _regroup_plain(inp, u, lo), reps=2)
    return out


def main(argv=None) -> None:
    modes, ab = split_ab(sys.argv[1:] if argv is None else argv)
    bad = [a for a in modes if a not in UPTOS]
    if bad:
        sys.exit(f"regroup_probe: no mode {bad}; one of {UPTOS}, or "
                 f"NAME=FILE.cu, NAME=K:V,..., --out DIR")
    own = (_build.CSRC_DIR / "regroup_probe.cu").read_text()
    texts, _, out = ab_sources(ab, own)
    texts.pop("new")
    dev = card("regroup_probe")
    uptos = tuple(u for u in UPTOS if u in modes) or UPTOS
    sources, dumps = {}, {"": (sass_dump(_build.build("regroup_probe")),
                               own)}
    print("[build] package: " + " | ".join(package_ptxas("regroup_probe")),
          flush=True)
    with ThreadPoolExecutor(max(1, len(texts))) as ex:  # one nvcc a source
        built = dict(zip(texts, ex.map(
            lambda kv: build(f"regroup_{kv[0]}", kv[1], out),
            texts.items())))
    for name, (path, ptxas) in built.items():
        sources[name] = bind(ctypes.CDLL(str(path)))
        dumps[f"{name} "] = (sass_dump(path), texts[name])
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
    lanes, sass = {}, {}
    for prefix, (dump, text) in dumps.items():
        n = source_lanes(text)
        if n is None:
            continue
        try:  # the staged form's; another source's form is only timed
            sass[prefix] = mode_sass(dump)
        except ValueError as e:
            if not prefix:
                raise
            print(f"[sass] {prefix}not counted: {e}", flush=True)
            continue
        lanes[prefix] = n
        print(f"[sass] {prefix or 'package '}(test, step, rank, rest): "
              f"{sass[prefix]}", flush=True)
    r = measure(probe_inputs(dev), uptos, sources=sources)
    lo, hi = WINDOWS
    pairs = r["pairs"]
    print(f"{pairs} pairs in {K} visits, {S} slots; {r['hits']} of {R} "
          f"rays hit; every mode and source bit-equal to its plain version "
          f"on 1, {lo} and {hi} windows (one block: one SM) and on "
          f"{CARD_BLOCKS} blocks; device time a call in a CUDA graph, "
          f"{ROUNDS} rounds in turns; the ring {ring_bytes()} B of dynamic "
          f"shared memory a block", flush=True)
    for name, v in r["modes"].items():
        prefix, u = name.rsplit(" ", 1) if " " in name else ("", name)
        prefix = prefix + " " if prefix else ""
        b = bound(u, pairs, 1, CARD_BLOCKS)
        fl = ""
        if prefix in sass and u in sass[prefix]:
            one = issue_floor(sass[prefix][u], pairs, 1, lanes[prefix],
                              SM_ISSUE_RATE) * 1e3
            fl = (f"; issue-rate floor {one:.2f} us a window on one SM, "
                  f"{issue_floor(sass[prefix][u], pairs, CARD_BLOCKS, lanes[prefix]):.4f}"
                  f" ms card-wide")
        plain = (f"; plain t({lo}) {v['plain_ms']:.3f} ms"
                 if "plain_ms" in v else "")
        print(f"  {name:14s}: {v['us_window']:8.3f} us/window on one SM "
              f"({v['ns_pair']:7.3f} ns/pair; t({lo}) {v['t'][0]:.4f} ms, "
              f"t({hi}) {v['t'][1]:.4f} ms); card-wide {CARD_BLOCKS} "
              f"windows {v['card_ms']:.4f} ms = "
              f"{v['card_ms'] / CARD_BLOCKS * 1e3:.4f} us/window, "
              f"{v['card_ns_pair']:.4f} ns/pair; bound {b[0]:.5f} ms by "
              f"{b[1]}{fl}{plain}", flush=True)


if __name__ == "__main__":
    main()
