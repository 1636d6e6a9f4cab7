"""A chain of 4 KB cluster copies into shared memory on Hopper's bulk-copy
engine, synchronous (K15a) or one copy ahead (K15b): the CUDA kernels
``csrc/dma_probe.cu``, their plain version, and the probe that gives the
latency a leaf visit exposes when it fetches its cluster and waits,
against a prefetch. The port's counterpart of ``experiments/dma_probe.py``
(``kern_sync``, ``kern_db``, through ``run``).

    python -m tpu_pathtracer_torch.experiments.dma_probe [parent=FILE.cu] \\
        [NAME=K:V,...] [--out DIR]

Copy i fetches cluster c_i = (i * 611) % C of C = 2048 4 KB clusters
(:func:`probe_blocks`, the TPU probe's ``arange * 1e-6``), and the result
is acc = sum_i blocks[c_i, 0], added in order: the same value in both
modes. Each copy is one ``cp.async.bulk`` issued by one thread and
completed on an mbarrier, as the TPU's ``make_async_copy`` with a DMA
semaphore is one copy engine's. :func:`dma_chain` dispatches on the device
of its input: a CPU tensor goes to the plain version (the same sum in the
same order), a CUDA tensor to the kernel or the call raises.

``main()`` runs :func:`measure`: each mode held equal to the plain sum and
timed in turns at k = 16,384 and 131,072 copies (device time a call in a
CUDA graph); it prints ns a copy (the slope between the two) for each mode
and the difference between them: the latency a prefetch one visit ahead
hides (ROADMAP B-17). ``parent=FILE.cu`` (say the first form, 256 threads
copying 16 B each: commit e02d93c's ``csrc/dma_probe.cu`` saved under a
gitignored directory) and ``NAME=K:V,...`` (this source with its
``constexpr int K`` set to V: ``nofence=kProxyFence:0``) add sources with
the same C entry, held bit-equal and timed in turns with the kernels;
``--out DIR`` keeps each build's ptxas lines and SASS.
"""

from __future__ import annotations

import ctypes
import re
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.experiments.common import (ab_sources,
                                                     bulk_chain, build, card,
                                                     graph_rounds, median_ms,
                                                     sass_dump,
                                                     sass_functions)
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops.cuda_spheres import _check

CLUSTERS = 2048
CLUSTER_FLOATS = 8 * 128  # 4 KB: the TPU probe's (8, 128) tile
STRIDE = 611
COPIES = (16_384, 131_072)  # the TPU probe's slope points
MODES = ("sync", "db")  # csrc/dma_probe.cu Mode, in order
# Kernel launches by dma_chain, per mode. Callers reset them to 0 and read
# them back to show that a run went through the kernel.
LAUNCHES = {mode: 0 for mode in MODES}
ROUNDS = 3
CALLS = 2  # calls a CUDA graph: each is milliseconds long
# one warp issues the chain: one instruction a cycle at the H100 SXM's
# 1,980 MHz maximum clock
WARP_ISSUE_RATE = 1.98e9


def probe_blocks(C: int = CLUSTERS, device="cuda") -> torch.Tensor:
    """The TPU probe's clusters, [C, 1024] f32: arange(C * 1024) * 1e-6."""
    return (torch.arange(C * CLUSTER_FLOATS, dtype=torch.float32,
                         device=device) * 1e-6).reshape(C, CLUSTER_FLOATS)


def _dma_chain_ref(blocks: torch.Tensor, k: int) -> torch.Tensor:
    """acc as a float32 scalar tensor: blocks[c_i, 0] summed in order, one
    float32 addition at a time (numpy's ``add.accumulate``)."""
    c = (np.arange(k, dtype=np.int64) * STRIDE) % blocks.shape[0]
    vals = blocks[:, 0].cpu().numpy()[c]
    acc = np.add.accumulate(vals, dtype=np.float32)[-1] if k else \
        np.float32(0.0)
    return torch.tensor(acc, dtype=torch.float32, device=blocks.device)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (the package's build or another source's) with
    ``dma_probe_launch``'s signature set."""
    fn = lib.dma_probe_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, ctypes.c_int, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(blocks: torch.Tensor, k: int, mode: str,
            lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """One launch through ``lib`` (default: the package's build, counted
    in LAUNCHES; another library's launches are not counted)."""
    dev = blocks.device
    C = blocks.shape[0]
    _check("blocks", blocks, dev, torch.float32, (C, CLUSTER_FLOATS))
    if blocks.data_ptr() % 16 or k < 0:
        raise ValueError("blocks must be 16-byte aligned, k >= 0")
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = (lib or bind(_build.load("dma_probe"))).dma_probe_launch(
            MODES.index(mode), blocks.data_ptr(), C, int(k), out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"dma_probe kernel launch failed: CUDA error {rc}")
    if lib is None:
        LAUNCHES[mode] += 1
    return out


def dma_chain(blocks: torch.Tensor, k: int, mode: str = "sync"
              ) -> torch.Tensor:
    """The chain of ``k`` cluster copies in ``mode`` (``MODES``); returns
    acc, a float32 scalar tensor."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    dev = blocks.device
    if dev.type == "cpu":
        return _dma_chain_ref(blocks, k)
    if dev.type != "cuda":
        raise ValueError(f"no dma_probe kernel for tensors on {dev}")
    return _launch(blocks, k, mode)


def measure(blocks: torch.Tensor, rounds: int = ROUNDS,
            sources: Optional[Dict[str, ctypes.CDLL]] = None) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 15 print it): both modes run once at each of
    COPIES and are held bit-equal to the plain sum there, as is each of
    ``sources`` ({name: library with the same C entry}, not counted in
    LAUNCHES); then all are timed in turns at both: device time a call in
    a CUDA graph (``common.graph_rounds``, ``rounds`` rounds). Returns a
    dict: ``launches`` (LAUNCHES after the checked run), and by name (a
    mode, or "<source> <mode>") ``t`` ((ms at k lo, ms at k hi)) and
    ``per_copy`` (ns, the slope); ``plain_ms`` (the plain sum at k
    lo)."""
    lo, hi = COPIES
    sources = sources or {}
    outs = {(m, k): dma_chain(blocks, k, m) for m in MODES for k in COPIES}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for k in COPIES:
        want = _dma_chain_ref(blocks, k)
        got = {m: outs[(m, k)] for m in MODES}
        got.update({f"{src} {m}": _launch(blocks, k, m, lib)
                    for src, lib in sources.items() for m in MODES})
        for name, acc in got.items():
            if not torch.equal(acc, want):
                raise AssertionError(f"{name} at k={k}: {acc.item()} != "
                                     f"the plain sum {want.item()}")
    plain_ms = median_ms(lambda: _dma_chain_ref(blocks, lo), reps=2)
    pkg = bind(_build.load("dma_probe"))
    calls = {prefix + m: (lambda k, m=m, lib=lib: _launch(blocks, k, m, lib))
             for prefix, lib in {"": pkg, **{f"{s} ": v for s, v in
                                             sources.items()}}.items()
             for m in MODES}
    times = graph_rounds(list(calls), list(COPIES),
                         lambda name, k: calls[name](k), rounds, calls=CALLS)
    t = {name: (times[name, lo], times[name, hi]) for name in calls}
    return {"launches": launches, "t": t, "plain_ms": plain_ms,
            "per_copy": {name: (b - a) / (hi - lo) * 1e6
                         for name, (a, b) in t.items()}}


def copy_sass(text: str) -> Dict[str, Tuple[int, int, int]]:
    """{mode: (instructions, bulk copies, waits)} of the chain loop of
    each kernel in a ``cuobjdump -sass`` dump (``sync_kernel``,
    ``db_kernel``; ``common.bulk_chain``). Raises if a kernel's chain loop
    lacks the bulk copy or the wait."""
    out = {}
    for name, code in sass_functions(text).items():
        m = re.search(r"(sync|db)_kernel", name)
        if m:
            out[m.group(1)] = bulk_chain(code, m.group(1))
    return out


def issue_floor(instructions: int, k: int) -> float:
    """ms: the least time one warp could issue ``k`` rounds of a chain
    loop of ``instructions`` (:func:`copy_sass`), one a cycle."""
    return instructions * k / WARP_ISSUE_RATE * 1e3


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    own = (_build.CSRC_DIR / "dma_probe.cu").read_text()
    texts, _, out = ab_sources(argv, own)
    texts.pop("new")
    dev = card("dma_probe")
    sources = {}
    for name, text in texts.items():
        lib, ptxas = build(f"dma_{name}", text, out)
        sources[name] = bind(ctypes.CDLL(str(lib)))
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
    sass = copy_sass(sass_dump(_build.build("dma_probe")))
    print(f"[sass] the chain loop (instructions, bulk copies, waits): "
          f"{sass}", flush=True)
    r = measure(probe_blocks(device=dev), sources=sources)
    lo, hi = COPIES
    print(f"{CLUSTERS} clusters of 4 KB, copy i from cluster (i * {STRIDE}) "
          f"% {CLUSTERS}, one warp; every mode and source equal to the "
          f"plain sum at k = {lo} and {hi} (plain t({lo}) "
          f"{r['plain_ms']:.3f} ms on the host); device time a call in a "
          f"CUDA graph, {ROUNDS} rounds in turns", flush=True)
    per = r["per_copy"]
    for name in per:
        floor = (f", issue-rate floor {sass[name][0] / WARP_ISSUE_RATE * 1e9:.1f}"
                 f" ns" if name in sass else "")
        print(f"  {name:12s}: {per[name]:7.1f} ns/copy (abs "
              f"{r['t'][name][0]:.3f} / {r['t'][name][1]:.3f} ms{floor})",
              flush=True)
    for prefix in ["", *(f"{s} " for s in sources)]:
        print(f"  {prefix}sync - db: {per[prefix + 'sync'] - per[prefix + 'db']:7.1f}"
              f" ns/copy hidden by a prefetch one copy ahead", flush=True)


if __name__ == "__main__":
    main()
