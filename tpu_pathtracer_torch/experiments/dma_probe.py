"""A chain of 4 KB cluster copies into shared memory, synchronous (K15a)
or one copy ahead (K15b): the CUDA kernels ``csrc/dma_probe.cu``, their
plain version, and the probe that gives the latency a leaf visit exposes
when it fetches its cluster and waits, against a prefetch. The port's
counterpart of ``experiments/dma_probe.py`` (``kern_sync``, ``kern_db``,
through ``run``).

    python -m tpu_pathtracer_torch.experiments.dma_probe

Copy i fetches cluster c_i = (i * 611) % C of C = 2048 4 KB clusters
(:func:`probe_blocks`, the TPU probe's ``arange * 1e-6``), and the result
is acc = sum_i blocks[c_i, 0], added in order: the same value in both
modes. :func:`dma_chain` dispatches on the device of its input: a CPU
tensor goes to the plain version (the same sum in the same order), a CUDA
tensor to the kernel or the call raises.

``main()`` runs :func:`measure`: each mode held equal to the plain sum and
timed in turns at k = 16,384 and 131,072 copies; it prints ns a copy (the
slope between the two) for each mode and the difference between them:
the latency a prefetch one visit ahead hides (ROADMAP B-17).
"""

from __future__ import annotations

import ctypes
import statistics

import numpy as np
import torch

from tpu_pathtracer_torch.experiments.common import card, in_turns, median_ms
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
ROUNDS = 2
REPS = 3


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("dma_probe")
    fn = lib.dma_probe_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, ctypes.c_int, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    return lib


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
    C = blocks.shape[0]
    _check("blocks", blocks, dev, torch.float32, (C, CLUSTER_FLOATS))
    if blocks.data_ptr() % 16 or k < 0:
        raise ValueError("blocks must be 16-byte aligned, k >= 0")
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().dma_probe_launch(MODES.index(mode), blocks.data_ptr(), C,
                                     int(k), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dma_probe kernel launch failed: CUDA error {rc}")
    LAUNCHES[mode] += 1
    return out


def measure(blocks: torch.Tensor, rounds: int = ROUNDS) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 15 print it): both modes run once at each of
    COPIES and are held bit-equal to the plain sum there, then timed in
    turns at both. Returns a dict: ``launches`` (LAUNCHES after the checked
    run), and by mode ``t`` ((ms at k lo, ms at k hi), medians of the
    in-turn readings) and ``per_copy`` (ns, the slope); ``plain_ms`` (the
    plain sum at k lo)."""
    lo, hi = COPIES
    outs = {(m, k): dma_chain(blocks, k, m) for m in MODES for k in COPIES}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for k in COPIES:
        want = _dma_chain_ref(blocks, k)
        for m in MODES:
            if not torch.equal(outs[(m, k)], want):
                raise AssertionError(f"{m} at k={k}: {outs[(m, k)].item()} "
                                     f"!= the plain sum {want.item()}")
    plain_ms = median_ms(lambda: _dma_chain_ref(blocks, lo), reps=2)
    readings = in_turns({(m, k): (lambda m=m, k=k: dma_chain(blocks, k, m))
                         for m in MODES for k in COPIES}, rounds, REPS)
    t = {m: tuple(statistics.median(readings[(m, k)]) for k in COPIES)
         for m in MODES}
    return {"launches": launches, "t": t, "plain_ms": plain_ms,
            "per_copy": {m: (b - a) / (hi - lo) * 1e6
                         for m, (a, b) in t.items()}}


def main() -> None:
    dev = card("dma_probe")
    r = measure(probe_blocks(device=dev))
    lo, hi = COPIES
    print(f"{CLUSTERS} clusters of 4 KB, copy i from cluster (i * {STRIDE}) "
          f"% {CLUSTERS}, one block; both modes equal to the plain sum at "
          f"k = {lo} and {hi} (plain t({lo}) {r['plain_ms']:.3f} ms on the "
          f"host); in turns, {ROUNDS} rounds forward and back, each reading "
          f"the median of {REPS}", flush=True)
    per = r["per_copy"]
    for m in MODES:
        print(f"  {m:4s}: {per[m]:7.1f} ns/copy (abs {r['t'][m][0]:.3f} / "
              f"{r['t'][m][1]:.3f} ms)", flush=True)
    print(f"  sync - db: {per['sync'] - per['db']:7.1f} ns/copy hidden by a "
          f"prefetch one copy ahead", flush=True)


if __name__ == "__main__":
    main()
