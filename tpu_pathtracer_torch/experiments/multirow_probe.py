"""A synthetic node step of the 8-row packet (K23): the CUDA kernel
``csrc/multirow_probes.cu`` (``walk8_kernel``), its plain PyTorch
version, and the probe that prices K12a's node round (a vote and a
warp-uniform advance) against K5's per-lane step. The port's counterpart
of ``experiments/multirow_probe.py`` (``_kernel``, through ``run``); the
8-row walk it shares with K24 (``gather_probe``) and the library of both
and of K22 (``leafround_probe``) live here.

    python -m tpu_pathtracer_torch.experiments.multirow_probe [N]
    python -m tpu_pathtracer_torch.experiments.multirow_probe \
        parent=<file.cu> [NAME=...]   # the walk's A/B (gather_probe's)

Eight rows of 128 ray lanes walk on their own. A step reads the left and
right boxes of the row's node pair (12 words), runs two slab tests a lane,
votes over the row's lanes (pref = sum of +-1 over lanes inside both boxes,
nearer right box +1; nl, nr the lanes in each) and advances the row's
bitstack: into both children (the preferred one first), into the one hit,
or pops (ctz of the bitstack). ``acc += lhit + rhit`` a lane. Modes:
``fixed`` (constant boxes: slab, vote and advance alone) and ``assemble``
(the boxes of pair idx from the flat table ``ntab``, words 12 idx to 12
idx + 11; on the card lanes 0-11 of the row's first warp load a word each
and hand the words to the row's warps through shared memory). On the card
each row runs on its own SM (over ``kWalkWarps`` warps in ``assemble``,
``kWalkWarpsFixed`` in ``fixed``), and a step's three votes are one packed
``__reduce_add_sync`` a warp (``csrc/multirow_probes.cu``).

Finding ROADMAP C-19: a box a row misses adds 1e30 to acc, which swallows
every hit's t in float32, so acc counts misses only, and a wrong advance
could leave it unchanged. The plain version and the kernel therefore also
return every step's idx and bs of each row (``trace=True``), and the
checks hold those.

Integers follow JAX's int32 and uint32 (int64 masked here, ROADMAP C-1);
min and max propagate a NaN as ``jnp.minimum``/``jnp.maximum`` do.
:func:`multirow_run` dispatches on the device of its rays: CPU tensors go
to the plain version, CUDA tensors to the kernel or the call raises.
``main()`` runs :func:`measure`: both modes held bit-equal to their plain
versions (acc, and the idx/bs trajectory) at 3 steps and at 64, then
timed in turns at the TPU file's 64 and 512 steps; the slope gives ns an
8-row node step.
"""

from __future__ import annotations

import ctypes
import re
import sys
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.experiments.common import (
    ISSUE_RATE, build, card, event_ms, fast_count, graph_rounds,
    natural_loops, opcode, package_ptxas, sass_dump, sass_functions)
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops.cuda_bvh import _ctz32
from tpu_pathtracer_torch.ops.cuda_spheres import _check

N = 4096             # nodes in the synthetic table (the TPU file's default)
ROWS, LANES = 8, 128
TILE = ROWS * LANES
FAR = 1e30
SLAB_EPS = 1e-4      # the slab test's least entry distance
BS0 = 0x15           # every row's starting bitstack
MODES = ("fixed", "assemble")
FETCH = {"fixed": 0, "assemble": 1, "shfl": 1, "lanes": 2}  # walk8 fetch
STEPS = (64, 512)    # the TPU file's slope points (:27)
CHECK_STEPS = 3
# Kernel launches by multirow_run, per mode. Callers reset them to 0 and
# read them back to show that a run went through the kernel.
LAUNCHES = {m: 0 for m in MODES}
ROUNDS = 2
AB_ROUNDS = 3    # the A/Bs' rounds in turns
AB_CALLS = 2     # calls a CUDA graph there: a first-form call takes ms
INT_MAX = 2 ** 31 - 1
# warp instructions a second one warp issues at most (its scheduler at the
# H100's 1,980 MHz maximum clock): a chain step's issue on one warp
WARP_ISSUE_RATE = 1.98e9

Walk = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def probe_inputs(n: int = N, device="cuda"):
    """The TPU file's inputs from its seed (``default_rng(0)``): (ntab (n
    * 6,) f32 standard normal, rays (7, 8, 128) f32 standard normal: o,
    d, and row 6 which only makes the cap 1e30), in its order."""
    rng = np.random.default_rng(0)
    ntab = rng.standard_normal(n * 6).astype(np.float32)
    rays = rng.standard_normal((7, ROWS, LANES)).astype(np.float32)
    return torch.from_numpy(ntab).to(device), torch.from_numpy(rays).to(device)


# ------------------------------------------------------ the shared walk
def slab(b: torch.Tensor, o, inv, closest) -> torch.Tensor:
    """The TPU probes' ``slab``: b [6, 8, 1] (lo xyz, hi xyz a row), o and
    inv [3, 8, 128], closest [8, 128]; the entry distance, 1e30 on a
    miss."""
    t0 = (b[:3] - o) * inv
    t1 = (b[3:] - o) * inv
    neg = inv < 0.0
    lo = torch.where(neg, t1, t0)
    hi = torch.where(neg, t0, t1)
    eps = torch.tensor(SLAB_EPS, dtype=torch.float32, device=o.device)
    tmin = torch.maximum(torch.maximum(lo[0], lo[1]),
                         torch.maximum(lo[2], eps))
    tmax = torch.minimum(torch.minimum(hi[0], hi[1]),
                         torch.minimum(hi[2], closest))
    return torch.where(tmax < tmin, FAR, tmin)


def walk8_ref(rays: torch.Tensor, fetch: Callable, steps: int, mask: int,
              or_bits: int, idx0: torch.Tensor) -> Walk:
    """The 8-row walk, ``steps`` steps from rows at ``idx0`` [8] with
    bitstack 0x15: ``fetch(idx)`` gives the 12 box words [12, 8] of each
    row's pair; the new idx is ``(idx' & mask) | or_bits``. Returns (acc
    (8, 128) f32, idx [steps, 8] int32, bs [steps, 8] int32), the last
    two after every step."""
    o, inv = rays[:3], 1.0 / rays[3:6]
    cl = rays[6] * 0.0 + FAR
    idx = idx0.to(torch.int64)
    bs = torch.full_like(idx, BS0)
    acc = torch.zeros_like(cl)
    idx_tr, bs_tr = [], []
    for _ in range(steps):
        b = fetch(idx)[:, :, None]                     # [12, 8, 1]
        lhit, rhit = slab(b[:6], o, inv, cl), slab(b[6:], o, inv, cl)
        tl, tr = lhit < cl, rhit < cl
        pref = torch.where(tl & tr, torch.where(rhit < lhit, 1, -1),
                           0).sum(1)
        vl, vr = tl.any(1), tr.any(1)
        swap = (pref > 0).to(torch.int64)
        both, single = vl & vr, vl ^ vr
        m = torch.where(bs > 0, _ctz32(bs), 0)
        bs_p = (bs >> m) ^ 1
        idx_p = (idx >> m) ^ 1
        l2 = idx * 2
        new_idx = torch.where(both, l2 + swap, torch.where(
            single, torch.where(vl, l2, l2 + 1), idx_p))
        new_bs = torch.where(both, (bs << 1) + 1, torch.where(
            single, bs << 1, bs_p)) & 0xFFFFFFFF
        idx = (new_idx & mask) | or_bits
        bs = new_bs & 0xFFFF
        bs = torch.where(bs == 0, 1, bs)
        acc = (acc + lhit) + rhit
        idx_tr.append(idx)
        bs_tr.append(bs)
    stack = lambda xs: (torch.stack(xs) if xs else torch.zeros(
        (0, ROWS), dtype=torch.int64, device=rays.device)).to(torch.int32)
    return acc, stack(idx_tr), stack(bs_tr)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (the package's build of ``csrc/multirow_probes.cu`` or
    another source with the same C entries) with K22's and the walk's
    launchers' signatures set, and their shape entries' where it has them
    (the first forms have none)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    for name, args, need in (
            ("leafround_probe_launch", [i, i, p, p, i, p, p], True),
            ("walk8_probe_launch", [i, i, p, p, i, i, p, p, p, p], True),
            ("leafround_probe_shape", [i, i, ip, ip, ip], False),
            ("walk8_probe_shape", [i, ip, ip, ip], False)):
        fn = getattr(lib, name, None)
        if fn is None and not need:
            continue
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    """``csrc/multirow_probes.cu``: K22's and the walk's launchers."""
    return bind(_build.load("multirow_probes"))


def source_lib(name: str, text: str, out: Optional[Path] = None):
    """(library, ptxas lines, nvcc log, SASS) of another source of the
    kernels with the same C entries (a parent, a variant, a yardstick),
    built by ``common.build`` as ``multirow_<name>`` and bound; ``out``
    keeps its ptxas lines and SASS."""
    path, ptxas, log = build(f"multirow_{name}", text, out, keep=True)
    return bind(ctypes.CDLL(str(path))), ptxas, log, sass_dump(path)


def build_sources(texts: Dict[str, str], out: Optional[Path] = None):
    """The A/Bs' builds: the package's ("new", library None) and each of
    ``texts`` ({name: source}, one nvcc each, all at once), their ptxas
    lines printed. Returns ({name: library}, {name: SASS}, {name: nvcc
    log}, {name: source text})."""
    own = _build.build("multirow_probes")
    libs, dumps = {}, {"new": sass_dump(own)}
    logs = {"new": own.with_suffix(".log").read_text()}
    srcs = {"new": (_build.CSRC_DIR / "multirow_probes.cu").read_text(),
            **texts}
    print("[build] new: " + " | ".join(package_ptxas("multirow_probes")),
          flush=True)
    with ThreadPoolExecutor(max(1, len(texts))) as ex:
        built = dict(zip(texts, ex.map(
            lambda kv: source_lib(kv[0], kv[1], out), texts.items())))
    for name, (lib, ptxas, log, dump) in built.items():
        libs[name], logs[name], dumps[name] = lib, log, dump
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
    return libs, dumps, logs, srcs


def device_of(steps: int, *tensors: torch.Tensor) -> torch.device:
    """The inputs' one device, CPU or CUDA; 0 <= steps < 2^31 (the C
    entries take an int)."""
    if steps < 0:
        raise ValueError(f"steps must be >= 0, not {steps}")
    if steps > INT_MAX:
        raise ValueError(f"steps must be below 2^31, not {steps}")
    dev = tensors[0].device
    if any(a.device != dev for a in tensors):
        raise ValueError("the inputs lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no 8-row probe kernel for tensors on {dev}")
    return dev


def pow2(name: str, n: int, least: int = 1) -> None:
    if n < least or n & (n - 1):
        raise ValueError(f"{name} must be a power of two >= {least}, not {n}")


def walk8(rays: torch.Tensor, tab: torch.Tensor, words: int, pairs: bool,
          fetch: str, steps: int, trace: bool,
          lib: Optional[ctypes.CDLL] = None) -> Walk:
    """Launch the 8-row walk on the card through ``lib`` (default: the
    package's build); (acc, idx, bs), the last two None unless
    ``trace``."""
    dev = rays.device
    _check("rays", rays, dev, torch.float32, (7, ROWS, LANES))
    if words > INT_MAX:
        raise ValueError(f"the table's {words} words exceed an int")
    acc = torch.empty((ROWS, LANES), dtype=torch.float32, device=dev)
    tr = [torch.empty((steps, ROWS), dtype=torch.int32, device=dev)
          for _ in range(2)] if trace else [None, None]
    ptr = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = (lib or _lib()).walk8_probe_launch(
            int(pairs), FETCH[fetch], rays.data_ptr(), tab.data_ptr(), words,
            int(steps), acc.data_ptr(), ptr(tr[0]), ptr(tr[1]), stream)
    if rc != 0:
        raise RuntimeError(f"walk8 {fetch} launch failed: CUDA error {rc}")
    return acc, tr[0], tr[1]


def shape(entry: str, *args, lib: Optional[ctypes.CDLL] = None
          ) -> Tuple[int, int, int]:
    """(blocks, threads a block, bytes of dynamic shared memory) of a
    launch of ``lib`` (default: the package's) from its shape entry
    ``entry`` (``leafround_probe_shape`` with mode and w, or
    ``walk8_probe_shape`` with the fetch)."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = getattr(lib or _lib(), entry)(*args, *(ctypes.byref(v)
                                                for v in vals))
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
    return tuple(v.value for v in vals)


def walk_shape(fetch: str, lib: Optional[ctypes.CDLL] = None
               ) -> Tuple[int, int, int]:
    """(blocks, threads a block, dynamic shared memory) of the walk's
    launch in the fetch mode ``fetch`` (a :data:`FETCH` name)."""
    return shape("walk8_probe_shape", FETCH[fetch], lib=lib)


# -------------------------------------------------------------- K23
def _ntab_fetch(ntab: torch.Tensor) -> Callable:
    words = torch.arange(12, device=ntab.device)
    return lambda idx: ntab[12 * idx[None, :] + words[:, None]]


_FIXED = torch.tensor([0.1 * i for i in range(6)]
                      + [0.1 * i + 0.05 for i in range(6)],
                      dtype=torch.float32)


def _multirow_ref(rays: torch.Tensor, ntab: torch.Tensor, steps: int,
                  mode: str) -> Walk:
    n = ntab.numel() // 6
    fixed = _FIXED.to(rays.device)
    fetch = ((lambda idx: fixed[:, None].expand(12, ROWS)) if mode == "fixed"
             else _ntab_fetch(ntab))
    idx0 = torch.arange(ROWS, device=rays.device) % (n // 2 - 1) + 1
    return walk8_ref(rays, fetch, steps, n // 2 - 1, 1, idx0)


def _multirow(rays: torch.Tensor, ntab: torch.Tensor, steps: int,
              mode: str, trace: bool, lib: Optional[ctypes.CDLL] = None
              ) -> Walk:
    """One K23 launch through ``lib`` (default: the package's, counted in
    LAUNCHES)."""
    dev = device_of(steps, rays, ntab)
    n = ntab.numel() // 6
    _check("ntab", ntab, dev, torch.float32, (n * 6,))
    pow2("N", n, 32)
    out = walk8(rays, ntab, n, False, mode, steps, trace, lib)
    if lib is None:
        LAUNCHES[mode] += 1
    return out


def multirow_run(rays: torch.Tensor, ntab: torch.Tensor, steps: int,
                 mode: str = "assemble", trace: bool = False) -> Walk:
    """K23: ``steps`` node steps of the 8 rows of ``rays`` ((7, 8, 128)
    f32) over ``ntab`` ((N * 6,) f32, N a power of two >= 32) in ``mode``:
    (acc (8, 128) f32; idx and bs [steps, 8] int32 after every step, or
    None unless ``trace``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    dev = device_of(steps, rays, ntab)
    if dev.type == "cpu":
        acc, idx, bs = _multirow_ref(rays, ntab, steps, mode)
        return (acc, idx, bs) if trace else (acc, None, None)
    return _multirow(rays, ntab, steps, mode, trace)


# ------------------------------------------------- SASS, floors, bytes
def source_constant(text: str, name: str) -> int:
    """The value of ``constexpr int name`` in a CUDA source."""
    m = re.search(rf"constexpr int {name} = (-?\d+);", text)
    if m is None:
        raise ValueError(f"no constexpr int {name} in the source")
    return int(m.group(1))


def _count(code, span, op: str) -> int:
    return sum(opcode(i).startswith(op) for _, i in code[span[0]:span[1] + 1])


def round_key(name: str) -> Optional[Tuple[int, int]]:
    """(mode, w) of a mangled ``leafround_kernel<MODE, W>``, else None."""
    m = re.search(r"leafround_kernelILi(\d)ELi(\d+)E", name)
    return None if m is None else (int(m.group(1)), int(m.group(2)))


def walk_key(name: str) -> Optional[Tuple[str, bool]]:
    """(fetch, pairs) of a mangled ``walk8_kernel<FETCH, PAIRS>`` (fetch
    by its :data:`FETCH` name, K23's shfl as "assemble"), else None."""
    m = re.search(r"walk8_kernelILi(\d)ELb([01])E", name)
    if m is None:
        return None
    pairs = m.group(2) == "1"
    return {(0, False): "fixed", (1, False): "assemble", (1, True): "shfl",
            (2, True): "lanes"}[int(m.group(1)), pairs], pairs


def round_sass(text: str, lanes: int) -> Dict[Tuple[int, int], tuple]:
    """{(mode, w): (a consumer warp's round, its tests a lane, the
    producer's chain step)} of K22's round loops in a ``cuobjdump -sass``
    dump (``leafround_kernel<MODE, W>``), warp instructions without the
    IEEE division's slow paths (``common.fast_count``); ``lanes`` the
    build's lanes a ray (``kRoundLanes``). The round loops are the natural
    loops that hold a MUFU.RCP (a test's division) and no inner such loop;
    the producer's is the one with the bulk copy (mode 2's ``UBLKCP``) or
    the store of the id to its ring (mode 1's ``STS``); mode 0 has none (0).
    A consumer's loop holds w / lanes tests and one REDUX, the producer's
    w / 32 and one (a REDUX.MIN each). Raises on another form (the first form: a thread a
    lane, all w triangles in one loop)."""
    out = {}
    for name, code in sass_functions(text).items():
        if round_key(name) is None:
            continue
        mode, w = round_key(name)
        loops = natural_loops(code)
        inside = lambda a, b: b[0] <= a[0] and a[1] <= b[1] and a != b
        rcp = [s for s in loops if _count(code, s, "MUFU.RCP")]
        leaf = [s for s in rcp if not any(inside(o, s) for o in rcp)]
        mark = {2: "UBLKCP", 1: "STS"}.get(mode)
        prod = [s for s in leaf if mark and _count(code, s, mark)]
        cons = [s for s in leaf if s not in prod]
        if len(prod) != (mode > 0) or len(cons) != 1:
            raise ValueError(f"K22 mode {mode} w={w}: {len(prod)} producer "
                             f"and {len(cons)} consumer round loops, not the "
                             f"spread form")
        want = [(cons[0], w // lanes, "consumer")] + [
            (s, w // 32, "producer") for s in prod]
        for span, n, who in want:
            if _count(code, span, "MUFU.RCP") != n:
                raise ValueError(f"K22 mode {mode} w={w}: the {who}'s round "
                                 f"loop holds {_count(code, span, 'MUFU.RCP')}"
                                 f" MUFU.RCP, not {n}")
            if _count(code, span, "REDUX.MIN") != 1:
                raise ValueError(f"K22 mode {mode} w={w}: the {who}'s merge "
                                 f"is not one REDUX.MIN")
        out[mode, w] = (fast_count(code, cons[0]), w // lanes,
                        fast_count(code, prod[0]) if prod else 0)
    if len(out) != 6:
        raise ValueError(f"K22 kernels found: {sorted(out)}")
    return out


def round_floor(sass: tuple, shape: Tuple[int, int, int]) -> float:
    """ns a round: the issue-rate floor of one round over the card
    (``common.ISSUE_RATE``) from :func:`round_sass`'s (consumer, tests,
    producer) and the launch's (blocks, threads, smem): each block's
    consumer warps' round loops and its producer's chain step."""
    consumer, _, producer = sass
    blocks, threads, _ = shape
    return blocks * ((threads // 32 - 1) * consumer + producer) / \
        ISSUE_RATE * 1e9


def walk_sass(text: str) -> Dict[Tuple[str, bool], tuple]:
    """{(fetch, pairs): (a warp's step, its REDUX.SUM, its BAR)} of the walk's
    step loop in a ``cuobjdump -sass`` dump (``walk8_kernel<FETCH,
    PAIRS>``; fetch by its :data:`FETCH` name, K23's "shfl" as
    "assemble"): the widest natural loop that holds a REDUX.SUM, its warp
    instructions without slow paths. Raises unless every walk kernel's
    step loop holds one REDUX.SUM (the packed vote)."""
    out = {}
    for name, code in sass_functions(text).items():
        key = walk_key(name)
        if key is None:
            continue
        loops = sorted((s for s in natural_loops(code)
                        if _count(code, s, "REDUX.SUM")),
                       key=lambda s: s[0] - s[1])
        if not loops:
            raise ValueError(f"walk {key}: no step loop with a REDUX.SUM")
        step = loops[0]
        if _count(code, step, "REDUX.SUM") != 1:
            raise ValueError(f"walk {key}: the step loop holds "
                             f"{_count(code, step, 'REDUX.SUM')} REDUX.SUM, "
                             f"not one packed vote")
        out[key] = (fast_count(code, step), 1, _count(code, step, "BAR"))
    if len(out) != 4:
        raise ValueError(f"walk kernels found: {sorted(out)}")
    return out


def walk_floor(instructions: int, shape: Tuple[int, int, int]
               ) -> Tuple[float, float]:
    """(ns a step over the card at the issue rate, ns a step's issue on
    one warp): the walk's step loop of ``instructions`` warp instructions
    issued by every warp of the launch's (blocks, threads, smem), and by
    one warp at its scheduler's rate, the chain's own floor."""
    blocks, threads, _ = shape
    return (blocks * threads // 32 * instructions / ISSUE_RATE * 1e9,
            instructions / WARP_ISSUE_RATE * 1e9)


def ptxas_by_kernel(log: str, key: Callable) -> Dict:
    """{key(mangled name): register and shared-memory line} of the
    functions of an nvcc log for which ``key`` (:func:`round_key`,
    :func:`walk_key`) is not None."""
    out, k = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            k = key(line.rsplit(" ", 1)[-1])
        elif k is not None and "registers" in line:
            out[k] = line.split(":", 1)[-1].strip()
            k = None
    return out


def pairs_visited(idx0: torch.Tensor, idx: torch.Tensor) -> int:
    """The distinct node pairs a walk fetches: each row's start pair and
    the pairs of every step's idx but the last (a trajectory [steps, 8])."""
    return torch.unique(torch.cat([idx0.reshape(-1).to(torch.int64),
                                   idx[:-1].reshape(-1).to(torch.int64)])
                        ).numel()


def walk_bytes(pairs: int) -> int:
    """The walk's bytes: 12 words of each distinct pair once, the rays in
    (7 components) and acc out."""
    return 48 * pairs + 4 * 7 * TILE + 4 * TILE


# ---------------------------------------------------------- measurement
def held(name: str, kerns: dict, plain: Callable, steps) -> float:
    """Run each of ``kerns`` (by mode, ``fn(steps, trace)``) and the plain
    version they share (``plain(steps)``) at each of ``steps`` with the
    trajectory; raise unless all three outputs are bit-equal. Returns the
    plain version's milliseconds at the last of ``steps`` (CUDA events)."""
    for s in steps:
        p = []
        ms = event_ms(lambda: p.extend(plain(s)))
        for mode, kern in kerns.items():
            k = kern(s, True)
            torch.cuda.synchronize()
            for what, a, b in zip(("acc", "idx", "bs"), k, p):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{name} {mode} at {s} steps: kernel != plain on "
                        f"{int((a != b).sum())} {what}")
    return ms


def slopes(fns: dict, plain_ms: dict, lo: int, hi: int, rounds: int
           ) -> dict:
    """Time ``fns`` (by key, ``fn(steps)``) in turns at lo and hi steps,
    device time a call in a CUDA graph (``common.graph_rounds``, AB_CALLS
    calls a graph, ``rounds`` rounds): launched one by one, a call that
    takes less than its host dispatch (K23 ``fixed`` at 64 or 512 steps)
    would read the dispatch. Returns by key ``t`` ((ms lo, ms hi)), ``ns``
    (the slope: ns a step) and ``plain_ms`` (``plain_ms[key]``, the plain
    version at lo)."""
    times = graph_rounds(list(fns), [lo, hi], lambda k, s: fns[k](s),
                         rounds, calls=AB_CALLS)
    out = {}
    for k in fns:
        t = (times[k, lo], times[k, hi])
        out[k] = {"t": t, "ns": (t[1] - t[0]) / (hi - lo) * 1e6,
                  "plain_ms": plain_ms[k]}
    return out


def measure(ntab: torch.Tensor, rays: torch.Tensor,
            rounds: int = ROUNDS) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 17 print it): both modes held bit-equal to
    their plain versions, acc and trajectory, at CHECK_STEPS and STEPS[0],
    then timed in turns at STEPS. Returns ``launches`` (LAUNCHES after the
    checked runs) and by mode ``t``, ``ns`` and ``plain_ms`` (the checked
    plain run at STEPS[0]; :func:`slopes`)."""
    lo, hi = STEPS
    plain_ms = {m: held("multirow", {m: lambda s, t, m=m: multirow_run(
        rays, ntab, s, m, t)}, lambda s, m=m: _multirow_ref(rays, ntab, s, m),
        (CHECK_STEPS, lo)) for m in MODES}
    launches = dict(LAUNCHES)
    out = slopes({m: (lambda s, m=m: multirow_run(rays, ntab, s, m))
                  for m in MODES}, plain_ms, lo, hi, rounds)
    return {"launches": launches, "modes": out}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if any("=" in a for a in argv):  # sources: the walk's A/B (gather_probe)
        from tpu_pathtracer_torch.experiments import gather_probe
        gather_probe.main(argv)
        return
    n = int(argv[0]) if argv else N
    dev = card("multirow_probe")
    ntab, rays = probe_inputs(n, dev)
    r = measure(ntab, rays)
    lo, hi = STEPS
    print(f"N={n}: both modes bit-equal to their plain versions (acc and "
          f"every step's idx and bs) at {CHECK_STEPS} and {lo} steps; "
          f"{walk_shape('assemble')[0]} blocks; device time a call in a "
          f"CUDA graph, {ROUNDS} rounds in turns", flush=True)
    for m, v in r["modes"].items():
        print(f"{m:9s}: {v['ns']:7.1f} ns per 8-row node step   "
              f"[t({lo})={v['t'][0]:.4f} ms t({hi})={v['t'][1]:.4f} ms, "
              f"plain t({lo}) {v['plain_ms']:.3f} ms]", flush=True)


if __name__ == "__main__":
    main()
