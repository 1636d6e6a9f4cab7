"""The 8-row node step with its boxes fetched from per-component tables
(K24): the CUDA kernel ``csrc/multirow_probes.cu`` (``walk8_kernel``),
its plain PyTorch version, and the probe that asks whether a row's box
words are cheaper loaded by every lane or loaded once and broadcast by
``__shfl_sync``. The port's counterpart of ``experiments/gather_probe.py``
(``_kernel``, through ``run``).

    python -m tpu_pathtracer_torch.experiments.gather_probe [S ...]
    python -m tpu_pathtracer_torch.experiments.gather_probe [S ...] \
        parent=<file.cu> [NAME=<file.cu>] [NAME=K:V,...] [--out DIR]

K23's walk (``multirow_probe``) with these differences, the TPU file's:
the 12 box words of node pair p are ``tabs[c].flat[p]`` (c = 0-5 left,
6-11 right) of a (12, S/8, 8, 128) table, S * 128 pairs, which the TPU
reads by two chained per-lane gathers; rows start at ``idx = (r * 37 + 1)
& (128 S - 1)``; the new idx is masked to ``128 S - 1`` (no ``| 1``); the
votes are ``any`` (the same as a count above 0); its ctz goes through the
float exponent (the same as ``__ffs - 1`` below 2^31). Modes, each a fetch
of the kernel: ``lanes`` (every lane loads the row's 12 words) and
``shfl`` (lane i < 12 loads word i and hands it on: the TPU's
``__shfl_sync`` broadcast, on the card through shared memory to the row's
warps).

acc counts misses only (ROADMAP C-19): the checks hold every step's idx
and bs of each row beside it. :func:`gather_run` dispatches on the device
of its rays: CPU tensors go to the plain version, CUDA tensors to the
kernel or the call raises. On the card a row runs on its own SM, its
lanes over ``kWalkWarps`` warps, with one packed vote a warp a step (the
file's header). ``main()`` runs :func:`measure`: both modes at each S held
bit-equal to the plain version (acc and trajectory) at 3 steps and at
1024, then timed in turns at the TPU file's 1024 and 8192 steps; the
slope gives ns an 8-row node step. With sources (``parent=`` the first
form, say commit 3255132's ``csrc/multirow_probes.cu`` saved under the
gitignored ``_chipcheck/``; a yardstick such as a one-step lead, or each
warp loading its own words; variants such as ``w1=kWalkWarps:1`` or
``fixed4=kWalkWarpsFixed:4``) it runs the walk's A/B, :func:`walk_ab`, over
K24's and K23's cells: each source bit-equal first (acc and trajectory),
then device time a call in CUDA graphs in turns, beside each build's
registers, the issue-rate floor of its SASS
(:func:`multirow_probe.walk_sass`) and the chain's latency floor.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.experiments import multirow_probe as mr
from tpu_pathtracer_torch.experiments import tpu_micro as um
from tpu_pathtracer_torch.experiments.common import (
    ab_sources, card, graph_rounds, split_ab)
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops.cuda_spheres import _check

SIZES = (8, 16, 32, 64, 128)   # table heights S (the TPU file's default)
MODES = ("lanes", "shfl")
STEPS = (1024, 8192)           # the TPU file's slope points (:30)
CHECK_STEPS = mr.CHECK_STEPS
# Kernel launches by gather_run, per mode. Callers reset them to 0 and read
# them back to show that a run went through the kernel.
LAUNCHES = {m: 0 for m in MODES}


def probe_inputs(sizes=SIZES, device="cuda"):
    """The TPU file's inputs from its seed (``default_rng(0)``): (rays (7,
    8, 128) f32, {S: tabs (12, S/8, 8, 128) f32}), all standard normal,
    drawn in its order (the rays, then a table for each S in turn)."""
    rng = np.random.default_rng(0)
    rays = rng.standard_normal((7, mr.ROWS, mr.LANES)).astype(np.float32)
    tabs = {s: rng.standard_normal((12, max(s // 8, 1), 8, 128)).astype(
        np.float32) for s in sizes}
    dev = lambda a: torch.from_numpy(a).to(device)
    return dev(rays), {s: dev(t) for s, t in tabs.items()}


def _height(tabs: torch.Tensor) -> int:
    return tabs.shape[1] * 8


def _gather_ref(rays: torch.Tensor, tabs: torch.Tensor, steps: int
                ) -> mr.Walk:
    pairs = _height(tabs) * 128
    flat = tabs.reshape(12, pairs)
    idx0 = (torch.arange(mr.ROWS, device=rays.device) * 37 + 1) & (pairs - 1)
    return mr.walk8_ref(rays, lambda idx: flat[:, idx], steps, pairs - 1, 0,
                        idx0)


def _gather(rays: torch.Tensor, tabs: torch.Tensor, steps: int, mode: str,
            trace: bool, lib: Optional[ctypes.CDLL] = None) -> mr.Walk:
    """One K24 launch through ``lib`` (default: the package's, counted in
    LAUNCHES)."""
    dev = mr.device_of(steps, rays, tabs)
    if tabs.dim() != 4:
        raise ValueError(f"tabs must have 4 dimensions, not {tabs.dim()}")
    s = _height(tabs)
    _check("tabs", tabs, dev, torch.float32, (12, s // 8, 8, 128))
    mr.pow2("S", s, 8)
    out = mr.walk8(rays, tabs, s * 128, True, mode, steps, trace, lib)
    if lib is None:
        LAUNCHES[mode] += 1
    return out


def gather_run(rays: torch.Tensor, tabs: torch.Tensor, steps: int,
               mode: str = "shfl", trace: bool = False) -> mr.Walk:
    """K24: ``steps`` node steps of the 8 rows of ``rays`` ((7, 8, 128)
    f32) over ``tabs`` ((12, S/8, 8, 128) f32, S a power of two >= 8) in
    ``mode``: (acc (8, 128) f32; idx and bs [steps, 8] int32 after every
    step, or None unless ``trace``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    dev = mr.device_of(steps, rays, tabs)
    if dev.type == "cpu":
        acc, idx, bs = _gather_ref(rays, tabs, steps)
        return (acc, idx, bs) if trace else (acc, None, None)
    return _gather(rays, tabs, steps, mode, trace)


def start_pairs(tabs: torch.Tensor) -> torch.Tensor:
    """Each row's first node pair, ``(r * 37 + 1) & (S * 128 - 1)``."""
    pairs = _height(tabs) * 128
    return (torch.arange(mr.ROWS, device=tabs.device) * 37 + 1) & (pairs - 1)


def measure(rays: torch.Tensor, tabs: Dict[int, torch.Tensor],
            rounds: int = mr.ROUNDS) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 17 print it): both modes at every S of
    ``tabs`` held bit-equal to the plain version, acc and trajectory, at
    CHECK_STEPS and STEPS[0], then all timed in turns at STEPS. Returns
    ``launches`` (LAUNCHES after the checked runs) and by (mode, S) ``t``,
    ``ns`` and ``plain_ms`` (the checked plain run at STEPS[0], which
    serves both modes; ``multirow_probe.slopes``)."""
    lo, hi = STEPS
    plain_ms = {}
    for s, tab in tabs.items():
        ms = mr.held(f"gather S={s}", {
            m: lambda n, t, m=m, tab=tab: gather_run(rays, tab, n, m, t)
            for m in MODES}, lambda n, tab=tab: _gather_ref(rays, tab, n),
            (CHECK_STEPS, lo))
        plain_ms.update({(m, s): ms for m in MODES})
    launches = dict(LAUNCHES)
    out = mr.slopes({(m, s): (lambda n, m=m, tab=tab: gather_run(rays, tab,
                                                                  n, m))
                     for s, tab in tabs.items() for m in MODES},
                    plain_ms, lo, hi, rounds)
    return {"launches": launches, "modes": out}


# (kernel, mode, table size) -> (launch fn(steps, trace, lib), plain
# fn(steps), the slope's pair)
WalkRuns = Dict[Tuple[str, str, int], Tuple[Callable, Callable, tuple]]


def walk_runs(rays: torch.Tensor, tabs: Dict[int, torch.Tensor],
              ntab: torch.Tensor, mr_rays: torch.Tensor) -> WalkRuns:
    """The walk's A/B cells: K24 in both fetch modes at every S of
    ``tabs``, K23 in both modes on ``ntab`` (its own rays ``mr_rays``)."""
    runs: WalkRuns = {}
    for s, tab in tabs.items():
        for m in MODES:
            runs["K24", m, s] = (
                lambda n, t, lib, tab=tab, m=m: _gather(rays, tab, n, m, t,
                                                        lib),
                lambda n, tab=tab: _gather_ref(rays, tab, n), STEPS)
    for m in mr.MODES:
        runs["K23", m, ntab.numel() // 6] = (
            lambda n, t, lib, m=m: mr._multirow(mr_rays, ntab, n, m, t, lib),
            lambda n, m=m: mr._multirow_ref(mr_rays, ntab, n, m), mr.STEPS)
    return runs


def walk_ab(runs: WalkRuns, sources: Dict[str, ctypes.CDLL],
            rounds: int = mr.AB_ROUNDS) -> Dict[tuple, tuple]:
    """The walk's A/B (K23 and K24, one kernel): the package's build
    ("new") and each of ``sources`` ({name: library with the same C
    entry}) held bit-equal to the plain version, acc and every step's idx
    and bs, in every cell of ``runs`` (:func:`walk_runs`) at CHECK_STEPS
    and the lower count of the cell's pair, then timed in turns at the
    pair, device time a call in a CUDA graph (``common.graph_rounds``).
    Returns {(name, cell): ((ms lo, ms hi), ns a step)}."""
    libs = {"new": None, **sources}
    for key, (fn, ref, pair) in runs.items():
        for n in (CHECK_STEPS, pair[0]):
            want = ref(n)
            for name, lib in libs.items():
                got = fn(n, True, lib)
                torch.cuda.synchronize()
                for what, a, b in zip(("acc", "idx", "bs"), got, want):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"{key} {name} at {n} steps: kernel != plain on "
                            f"{int((a != b).sum())} {what}")
    cells = [(key, n) for key, (_, _, pair) in runs.items() for n in pair]
    times = graph_rounds(list(libs), cells, lambda name, c: runs[c[0]][0](
        c[1], False, libs[name]), rounds, calls=mr.AB_CALLS)
    out = {}
    for name in libs:
        for key, (_, _, (lo, hi)) in runs.items():
            t = (times[name, (key, lo)], times[name, (key, hi)])
            out[name, key] = (t, (t[1] - t[0]) / (hi - lo) * 1e6)
    return out


def ab_main(dev, texts: Dict[str, str], out, sizes) -> None:
    """Build ``texts`` ({name: source}), run :func:`walk_ab` on the TPU
    files' inputs (K24 at ``sizes``, K23 at N) and print each source's ns
    a step beside its registers, its launch, the issue-rate floor of its
    build's SASS (:func:`multirow_probe.walk_sass`) and the chain's latency
    floor (a step's issue on one warp, and but in ``fixed`` K17a
    ``smem``'s dependent on-chip load a step, measured here beside K17a
    ``l2``'s)."""
    libs, dumps, logs, _ = mr.build_sources(texts, out)
    rays, tabs = probe_inputs(sizes, dev)
    ntab, mr_rays = mr.probe_inputs(device=dev)
    trips = um.round_trips(um.probe_inputs(dev))
    trip = trips["smem"]
    r = walk_ab(walk_runs(rays, tabs, ntab, mr_rays), libs)
    print(f"walk (K24 at S = {', '.join(map(str, sizes))}, K23 at N = "
          f"{mr.N}): each source bit-equal to the plain version (acc and "
          f"every step's idx and bs) at {CHECK_STEPS} steps and the pair's "
          f"lower count; device time a call in a CUDA graph, {mr.AB_ROUNDS} "
          f"rounds in turns; K17a's dependent load a step here: smem "
          f"{trip:.1f} ns (the latency floor's), l2 {trips['l2']:.1f} ns",
          flush=True)
    for (name, (k_id, m, size)), ((t_lo, t_hi), ns) in r.items():
        key = (m, k_id == "K24")
        ptx = mr.ptxas_by_kernel(logs[name], mr.walk_key).get(key, "")
        try:
            sass = mr.walk_sass(dumps[name])[key]
            shape = mr.walk_shape(m, libs.get(name))
        except (ValueError, AttributeError):  # another form (the first)
            floor = ""
        else:
            card_ns, warp_ns = mr.walk_floor(sass[0], shape)
            lat = warp_ns + (0.0 if m == "fixed" else trip)
            floor = (f"; {shape[0]} blocks of {shape[1]} threads; SASS "
                     f"{sass} (a warp's step, REDUX, BAR), issue-rate floor "
                     f"{card_ns:.1f} ns a step card-wide, a step's issue "
                     f"{warp_ns:.1f} ns, latency floor {lat:.1f} ns")
        lo, hi = STEPS if k_id == "K24" else mr.STEPS
        print(f"  {k_id} {m:8s} {'S' if k_id == 'K24' else 'N'}={size:<5d} "
              f"{name:10s}: {ns:8.1f} ns a step (t({lo}) {t_lo:.4f} ms, "
              f"t({hi}) {t_hi:.4f} ms; {ptx}{floor})", flush=True)


def main(argv=None) -> None:
    argv, ab = split_ab(sys.argv[1:] if argv is None else argv)
    sizes = tuple(int(a) for a in argv) or SIZES
    dev = card("gather_probe")
    if ab:
        texts, _, out = ab_sources(
            ab, (_build.CSRC_DIR / "multirow_probes.cu").read_text())
        texts.pop("new")
        ab_main(dev, texts, out, sizes)
        return
    rays, tabs = probe_inputs(sizes, dev)
    r = measure(rays, tabs)
    lo, hi = STEPS
    print(f"both modes at S = {', '.join(map(str, sizes))} bit-equal to the "
          f"plain version (acc and every step's idx and bs) at "
          f"{CHECK_STEPS} and {lo} steps; {mr.walk_shape('shfl')[0]} "
          f"blocks; device time a call in a CUDA graph, {mr.ROUNDS} rounds "
          f"in turns", flush=True)
    for (m, s), v in r["modes"].items():
        print(f"S={s:4d} ({s * 128} node-pairs) {m:5s}: {v['ns']:7.1f} ns "
              f"per 8-row node step   [t({lo})={v['t'][0]:.4f} ms "
              f"t({hi})={v['t'][1]:.4f} ms, plain t({lo}) "
              f"{v['plain_ms']:.3f} ms]", flush=True)


if __name__ == "__main__":
    main()
