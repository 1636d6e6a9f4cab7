"""What the probes share on the card: the card's line, CUDA-event times,
kernels timed in turns or in a CUDA graph, device times from the
profiler, a first bounce's ray sets, the walk telemetry they print, and
the A/Bs' command line, builds of a kernel's other sources (``bvh4_ab``,
``spheres_ab``, ``spheres_mx_ab``, ``bvh_mx_ab``, ``bvh_ab``,
``bvh_rg_ab``, ``bvh_mr_ab``), their timing rounds and their SASS's counts.

A probe needs a CUDA device: :func:`card` exits non-zero without one
(the kernels have no CPU mode), and prints the ``nvidia-smi`` name and
power limit first, so every time a probe prints stands beside them.
"""

from __future__ import annotations

import contextlib
import re
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List
from unittest import mock

import torch

from tpu_pathtracer_torch.engine import wavefront as wf
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

WARP = 32
# warp instructions a second an H100 SXM issues at most: 132 SMs x 4
# schedulers at its 1,980 MHz maximum clock, one a scheduler a cycle
ISSUE_RATE = 528 * 1.98e9
# its published FP32 rate outside the tensor cores and its memory rate
FP32_RATE, HBM_RATE = 67e12, 3.35e12


def card(probe: str) -> torch.device:
    """The first CUDA device, after printing its ``nvidia-smi`` name and
    power limit; exits with ``probe``'s name if there is none."""
    if not torch.cuda.is_available():
        sys.exit(f"{probe}: no CUDA device; the kernels have no CPU mode")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return torch.device("cuda", 0)


def roofline(flops: float, nbytes: float):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of ``flops`` over its FP32 rate and ``nbytes`` over its
    memory rate."""
    t_ops = flops / FP32_RATE * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def event_ms(fn: Callable) -> float:
    """Milliseconds of one call of ``fn`` on the current stream, by CUDA
    events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def median_ms(fn: Callable, reps: int = 7) -> float:
    """The median of ``reps`` timed calls of ``fn``."""
    return statistics.median(event_ms(fn) for _ in range(reps))


def in_turns(fns: Dict[str, Callable], rounds: int = 4,
             reps: int = 7) -> Dict[str, List[float]]:
    """Each of ``fns`` timed in turns: ``rounds`` rounds of the names in
    order and then in reverse (A, B, C, C, B, A), each reading the median
    of ``reps`` calls, after one warm-up call of each. Returns every
    name's readings, two a round."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    order = list(fns) + list(fns)[::-1]
    out: Dict[str, List[float]] = {name: [] for name in fns}
    for _ in range(rounds):
        for name in order:
            out[name].append(median_ms(fns[name], reps))
    return out


def graph_ms(fn: Callable, calls: int = 20, reps: int = 5) -> float:
    """Device milliseconds of a call of ``fn``: ``calls`` calls captured
    in one CUDA graph, whose replay is timed by CUDA events (median of
    ``reps`` after a warm-up replay) and divided by ``calls``. No host
    dispatch stands between the launches, which at the lane pool's size
    would take longer than the kernel (PERF.md: K25 at 16,384 rays)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return median_ms(graph.replay, reps) / calls


def first_bounce(scene, view, cfg, o1, d1, pix, patches):
    """Bounce 0 of the rays ``o1``/``d1`` through the engine, with
    ``patches`` ((module, name, function) triples, say the plain versions
    of the kernels) in place. Returns (the second-bounce rays with t_max
    = -1 on dead lanes, the NEE shadow rays as they reach the any-hit
    test, or None in a scene without NEE)."""
    shadow = {}
    real = wf.occluded

    def catch(scene_, view_, config_, origin, direction, t_max):
        shadow.update(origin=origin, direction=direction,
                      t_max=t_max.contiguous())
        return real(scene_, view_, config_, origin, direction, t_max)

    alive = torch.ones_like(pix, dtype=torch.bool)
    with contextlib.ExitStack() as stack:
        for mod, name, fn in patches:
            stack.enter_context(mock.patch.object(mod, name, fn))
        stack.enter_context(mock.patch.object(wf, "occluded", catch))
        st, _ = wf.bounce_step(scene, view, cfg,
                               wf.initial_state(o1, d1, alive), pix, 0, 0)
    o2 = V3(*(c.contiguous() for c in st.origin))
    d2 = V3(*(c.contiguous() for c in st.direction))
    t2 = torch.where(st.alive, FLT_MAX, -1.0).contiguous()
    nee = ((shadow["origin"], shadow["direction"], shadow["t_max"])
           if shadow else None)
    return (o2, d2, t2), nee


def device_ms(fn: Callable, reps: int = 7) -> Dict[str, float]:
    """Device milliseconds a launch of each kernel or copy that ``fn``
    runs, by name, from ``torch.profiler`` over ``reps`` calls after one
    warm-up call: the device's own time, without the host's dispatch,
    which CUDA events around a call of a short kernel measure instead.
    The mean is over the launches the profiler recorded, which in a
    process that has profiled before can be fewer than were made. Empty
    if the profiler reported no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / e.count
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def sphere_pairs(origin: V3, direction: V3, tab: torch.Tensor,
                 t_min: float, t_max: torch.Tensor, chunk: int = 1 << 17):
    """(pairs, disc pairs) of csrc/spheres.cu's nearest modes on these
    rays: the (ray, sphere) pairs it tests, every slot of ``tab`` [S, 4]
    for each ray with t_max > t_min, and of those the pairs with
    disc > 0, where it takes the roots (the plain version's b and c)."""
    live = t_max > t_min
    pairs = int(live.sum()) * tab.shape[0]
    disc_pairs = 0
    for a in range(0, origin.x.shape[0], chunk):
        o = V3(*(c[a:a + chunk, None] for c in origin))
        d = V3(*(c[a:a + chunk, None] for c in direction))
        ocx, ocy, ocz = o.x - tab[:, 0], o.y - tab[:, 1], o.z - tab[:, 2]
        b = ocx * d.x + ocy * d.y + ocz * d.z
        c = ocx * ocx + ocy * ocy + ocz * ocz - tab[:, 3]
        hit = (b * b - c > 0.0) & live[a:a + chunk, None]
        disc_pairs += int(hit.sum())
    return pairs, disc_pairs


def distinct(ids: List[torch.Tensor]) -> int:
    """The number of distinct ids in a walk's ``visits`` list."""
    return torch.unique(torch.cat(ids)).numel() if ids else 0


def per_ray(cnt: torch.Tensor) -> str:
    """Steps and leaves of a per-ray counter block [5, N] (bvh.cu's
    order): mean per ray, and the mean over 32-ray warps of the most one
    lane takes (the steps the warp issues); N a multiple of 32."""
    steps = (cnt[0] + cnt[1]).double()
    leaves = cnt[2].double()
    warp = lambda c: c.view(-1, WARP).max(dim=1).values.mean().item()
    return (f"steps/ray {steps.mean().item():7.1f} (warp max "
            f"{warp(steps):7.1f})  leaves/ray {leaves.mean().item():6.1f} "
            f"(warp max {warp(leaves):6.1f})")


def variant(text: str, spec: str) -> str:
    """``text`` with each ``constexpr int K`` of ``spec`` ("K:V,...") set
    to V."""
    for kv in spec.split(","):
        k, v = kv.split(":")
        text, n = re.subn(rf"constexpr int {k} = -?\d+;",
                          f"constexpr int {k} = {int(v)};", text)
        if n != 1:
            raise ValueError(f"no constexpr int {k} in the source")
    return text


def split_ab(argv: List[str]):
    """(the arguments of a probe's own, the A/B's: ``NAME=...`` and
    ``--out DIR``), in order."""
    argv = list(argv)
    ab = []
    if "--out" in argv:
        k = argv.index("--out")
        ab, argv[k:k + 2] = argv[k:k + 2], []
        if len(ab) < 2:
            sys.exit("--out needs a directory")
    return ([a for a in argv if "=" not in a],
            [a for a in argv if "=" in a] + ab)


def ab_sources(argv: List[str], new: str):
    """An A/B's command line: ``NAME=PATH`` (a source file) and
    ``NAME=K:V,...`` (``new`` with its constants set, :func:`variant`),
    in order, then ``new`` itself as "new" unless named; ``--noleaf``;
    ``--out DIR``. Returns ({name: source text}, whether --noleaf was
    given, DIR or None)."""
    argv = list(argv)
    out = None
    if "--out" in argv:
        k = argv.index("--out")
        out = Path(argv.pop(k + 1))
        argv.pop(k)
    cut = "--noleaf" in argv
    texts = {}
    for arg in (a for a in argv if a != "--noleaf"):
        name, what = arg.split("=", 1)
        texts[name] = (variant(new, what) if ":" in what
                       else Path(what).read_text())
    texts.setdefault("new", new)
    return texts, cut, out


# the nearest leaf loops of the heap kernels' split form (csrc/bvh.cu,
# csrc/bvh_mx.cu) and of their first forms (one thread a ray), and the
# same loops cut
HEAP_LEAF_LOOPS = (("for (int k = s; k < P; k += L)",
                    "for (int k = s; k < 0; k += L)"),
                   ("for (int k = 0; k < P; ++k)",
                    "for (int k = 0; k < 0; ++k)"))


def noleaf(text: str, loops=HEAP_LEAF_LOOPS) -> str:
    """``text`` with the first of ``loops`` ((loop, cut loop) pairs) that
    it holds cut: its first occurrence, the nearest mode's."""
    for old, new in loops:
        if old in text:
            return text.replace(old, new, 1)
    raise ValueError("no known leaf loop in the source")


def build(name: str, text: str, out: Path | None, keep: bool = False):
    """(library path, ptxas lines) of ``text`` built as ``name``, and with
    ``keep`` the compiler's whole output third."""
    src = _build.BUILD_DIR / "ab" / f"{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    lib = src.with_suffix(".so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC_DIR), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{name}.ptxas.txt").write_text(log)
        (out / f"{name}.sass").write_text(sass_dump(lib))
    return (lib, ptxas_lines(log), log) if keep else (lib, ptxas_lines(log))


def ptxas_lines(log: str) -> List[str]:
    """The register, shared-memory and spill lines of an nvcc log."""
    return [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def package_ptxas(name: str) -> List[str]:
    """:func:`ptxas_lines` of the package's build of ``csrc/<name>.cu``
    (``ops/_build.py`` keeps its log beside the library)."""
    return ptxas_lines(_build.build(name).with_suffix(".log").read_text())


def graph_rounds(names: List, cells: List, call: Callable,
                 rounds: int, calls: int = 20) -> Dict:
    """{(name, cell): median ms} of ``call(name, cell)``, each timed by
    :func:`graph_ms` (``calls`` calls a graph) in ``rounds`` rounds, the
    names in order in even rounds and in reverse in odd ones, every cell
    of a name in a row."""
    times: Dict = {}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            for cell in cells:
                times.setdefault((name, cell), []).append(
                    graph_ms(lambda: call(name, cell), calls))
    return {k: statistics.median(v) for k, v in times.items()}


def sass_dump(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library (the toolkit's beside
    ``nvcc``); raises if it fails."""
    dump = Path(_build.nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(dump), "-sass", str(lib)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"cuobjdump failed on {lib}:\n{proc.stderr}")
    return proc.stdout


_SASS_FUNCTION = re.compile(r"Function : (\S+)")
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass_functions(text: str) -> Dict[str, List[tuple]]:
    """{mangled name: [(address, instruction), ...]} of a
    ``cuobjdump -sass`` dump, the instruction with its predicate."""
    out: Dict[str, List[tuple]] = {}
    name = None
    for line in text.splitlines():
        m = _SASS_FUNCTION.search(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _SASS_LINE.search(line)
        if name and m:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def branch_target(ins: str) -> int | None:
    """The address a SASS branch jumps to, or None for another
    instruction."""
    m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)$", ins)
    return int(m.group(1), 16) if m else None


def opcode(ins: str) -> str:
    """The opcode of a SASS instruction, its predicate dropped."""
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def sass_counts(text: str, ops=("HMMA", "LDSM")) -> Dict[str, tuple]:
    """{mangled name: (instructions, then the count of each of ``ops``
    by opcode prefix)} of a ``cuobjdump -sass`` dump."""
    return {name: (len(code), *(sum(opcode(i).startswith(op)
                                    for _, i in code) for op in ops))
            for name, code in sass_functions(text).items()}


def backward_loops(code: List[tuple]) -> List[tuple]:
    """[(head, end)]: the index spans of a function's loops (``code`` as
    :func:`sass_functions` gives it), one a backward branch; a branch to
    itself (the trap after the last EXIT) is none."""
    addr = [a for a, _ in code]
    out = []
    for k, (a, ins) in enumerate(code):
        t = branch_target(ins)
        if t is not None and t < a and t in addr:
            out.append((addr.index(t), k))
    return out


def body_loops(code: List[tuple]) -> List[tuple]:
    """:func:`backward_loops` that close before the function's last EXIT.
    The code after it holds out-of-line stubs (a divergent warp's
    shuffles, an mbarrier wait's retries) whose branches back into the
    body close no loop of it."""
    last = max(k for k, (_, i) in enumerate(code) if opcode(i) == "EXIT")
    return [s for s in backward_loops(code) if s[1] < last]


def natural_loops(code: List[tuple]) -> List[tuple]:
    """:func:`backward_loops` whose head dominates the branch back to it:
    every path from the entry to the branch passes the head. An
    out-of-line stub (a divergent warp's shuffles, an mbarrier wait's
    retries) is entered by a branch from before the head it returns to,
    so it closes no loop; a loop that ends in a predicated EXIT (a warp's
    branch that returns after its loop) is kept, where :func:`body_loops`
    would drop every loop after the last EXIT."""
    addr = {a: k for k, (a, _) in enumerate(code)}
    succ = []
    for k, (_, ins) in enumerate(code):
        op, t = opcode(ins), branch_target(ins)
        nxt = [] if (op in ("EXIT", "RET") or op.startswith("BRA")) \
            and not ins.startswith("@") else [k + 1]
        if t is not None and t in addr:
            nxt.append(addr[t])
        m = re.search(r"\bCALL\.REL\S*\s+(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) in addr:
            nxt.append(addr[int(m.group(1), 16)])
        succ.append([j for j in nxt if j < len(code)])

    def reaches(target: int, cut: int) -> bool:
        seen, todo = {0}, [0]
        while todo:
            k = todo.pop()
            if k == target:
                return True
            for j in succ[k]:
                if j != cut and j not in seen:
                    seen.add(j)
                    todo.append(j)
        return False

    return [(h, k) for h, k in backward_loops(code)
            if h != 0 and not reaches(k, h)]


def slow_paths(code: List[tuple], lo: int, hi: int) -> set:
    """The indices in [lo, hi] that a forward branch jumps over to skip a
    CALL and no MUFU: an IEEE division's or square root's slow path, which
    the kernels' inputs do not take."""
    addr = [a for a, _ in code]
    slow = set()
    for k in range(lo, hi + 1):
        t = branch_target(code[k][1])
        if t is None or t <= code[k][0] or t not in addr:
            continue
        end = addr.index(t)
        ops = [opcode(i) for _, i in code[k + 1:end]]
        if (end <= hi + 1 and any(o.startswith("CALL") for o in ops)
                and not any(o.startswith("MUFU") for o in ops)):
            slow.update(range(k + 1, end))
    return slow


def fast_count(code: List[tuple], span: tuple) -> int:
    """The instructions of ``span`` (inclusive index pair) but its slow
    paths."""
    lo, hi = span
    return hi + 1 - lo - len(slow_paths(code, lo, hi))


# the SASS of a bulk copy and of an mbarrier's try_wait
BULK_COPY, BARRIER_WAIT = "UBLKCP", "SYNCS.PHASECHK"


def bulk_chain(code: List[tuple], what: str) -> tuple:
    """(instructions, bulk copies, waits) of the chain loop of a function
    (``code`` as :func:`sass_functions` gives it) that copies by the
    bulk-copy engine a step: the widest loop that holds a ``UBLKCP``, its
    instructions counted once (an mbarrier spin loop's once), and its
    ``UBLKCP`` and ``SYNCS.PHASECHK``. Raises, naming ``what``, if no loop
    holds a bulk copy and an mbarrier wait."""
    count = lambda s, op: sum(opcode(i).startswith(op)
                              for _, i in code[s[0]:s[1] + 1])
    loops = sorted(body_loops(code), key=lambda s: s[0] - s[1])
    chain = next((s for s in loops if count(s, BULK_COPY)), None)
    if chain is None or not count(chain, BARRIER_WAIT):
        raise ValueError(f"{what}: no chain loop with a bulk copy "
                         f"({BULK_COPY}) and an mbarrier wait "
                         f"({BARRIER_WAIT})")
    return (fast_count(code, chain), count(chain, BULK_COPY),
            count(chain, BARRIER_WAIT))
