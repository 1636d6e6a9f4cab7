"""V back-to-back visits of a 1024-ray tile to a 64-triangle cluster
(K14): the CUDA kernel ``csrc/leafmt_probe.cu``, its plain PyTorch
version, and the probe that gives the floor of a leaf test with no
traversal around it and the cost of each way of fetching the cluster. The
port's counterpart of ``experiments/leafmt_probe.py`` (``_kernel``,
through ``run``).

    python -m tpu_pathtracer_torch.experiments.leafmt_probe [--blocks B]

Visit i tests cluster 0 (modes ``pure``, ``cond``) or cluster i % C
(``dma``, ``db``, ``db2``; C = 611), its 64 slots in order, as a
strict-less nearest update of (closest, besti = i*64 + w). The modes are
the TPU probe's, each in its GPU form (``csrc/leafmt_probe.cu``): the
cluster staged once in shared memory (``pure``), plus a branch a visit
(``cond``), read per lane from global memory every visit (``dma``, K5's
form), staged one visit ahead with ``cp.async`` into a two-slot ring
(``db``). ``db2`` computes ``db``'s function and its dynamic slot is what
the ``db`` kernel does anyway, so the ``db`` kernel serves it (counted
under ``db2``). :func:`leafmt_run` dispatches on the device of its
inputs: CPU tensors go to the plain version, CUDA tensors to the kernel
or the call raises.

The inputs are the TPU probe's, from its seed (:func:`probe_arrays`):
611 random 64-triangle clusters in its (C, 16, 128) block layout, which
:func:`clusters_from_blocks` turns into the kernel's [C, 64, 12] rows,
and one (8, 128) tile of rays. ``--blocks B`` runs B copies of the tile,
one a CUDA block (132 fills an H100's SMs). ``main()`` runs
:func:`measure`: every mode held bit-equal to its plain version and timed
in turns at V = 1024 and 17,408 visits; it prints the
per-visit slope, as the TPU probe does, in ns a visit and ns a triangle
slot.
"""

from __future__ import annotations

import ctypes
import statistics
import sys
from typing import Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.experiments.common import card, in_turns, median_ms
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops.cuda_spheres import _check, _on_cuda
from tpu_pathtracer_torch.ops.v3 import V3

WIDTH = 64     # triangles a cluster
TILE = 1024    # rays a tile: the TPU probe's (8, 128)
CLUSTERS = 611
T_MIN = 1e-3   # the TPU probe's
VISITS = (1024, 17_408)  # the TPU probe's slope points (:214)
MODES = ("pure", "cond", "dma", "db", "db2")
_KERNEL_MODE = {"pure": 0, "cond": 1, "dma": 2, "db": 3, "db2": 3}
SERVED_BY = {"db2": "db"}  # a mode that another mode's kernel computes
# Kernel launches by leafmt_run, per mode. Callers reset them to 0 and
# read them back to show that a run went through the kernel.
LAUNCHES = {mode: 0 for mode in MODES}
_CHUNK = 1 << 22  # ray-slot pairs a pass of the plain version
ROUNDS = 2
REPS = 3


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("leafmt_probe")
    fn = lib.leafmt_probe_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([ctypes.c_int] + [p] * 8 + [ctypes.c_int] * 4
                       + [p] * 3)
        fn.restype = ctypes.c_int
    return lib


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
            rc = _lib().leafmt_probe_launch(
                _KERNEL_MODE[mode],
                *(a.data_ptr() for a in (*origin, *direction, tmax)),
                clusters.data_ptr(), C, int(visits), int(skip), n,
                closest.data_ptr(), best.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"leafmt_probe kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES[mode] += 1
    return closest, best


def measure(args, rounds: int = ROUNDS) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 15 print it), on ``args`` (:func:`probe_inputs`).
    Every mode runs once at each slope point (VISITS, both past the
    clusters' wrap) and is held bit-equal to its plain version there; then
    the modes are timed in turns at both points. ``db2`` is checked and
    counted, and takes ``db``'s times: the same kernel (``SERVED_BY``).

    Returns a dict by mode: ``launches`` (LAUNCHES after the checked run),
    ``t`` ((ms at V lo, ms at V hi), medians of the in-turn readings),
    ``per_visit`` (ns, the slope), ``plain_ms`` (the plain version at V lo;
    ``pure`` and ``cond`` share one function, the rest another) and
    ``hits`` (rays with a winner at V lo)."""
    lo, hi = VISITS
    outs = {(m, v): leafmt_run(*args, v, m) for m in MODES for v in VISITS}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    plain_ms = {}
    for fn in ("pure", "dma"):  # the two functions the modes compute
        for v in VISITS:
            want = _leafmt_ref(*args, v, fn)
            for m in MODES:
                got = outs[(m, v)]
                if (_KERNEL_MODE[m] >= 2) == (fn == "dma") and not all(
                        torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(
                        f"{m}: differs from its plain version at V={v} on "
                        f"{int((got[1] != want[1]).sum())} winners, "
                        f"{int((got[0] != want[0]).sum())} t")
        plain_ms[fn] = median_ms(lambda fn=fn: _leafmt_ref(*args, lo, fn),
                                 reps=2)
    timed = [m for m in MODES if m not in SERVED_BY]
    readings = in_turns({(m, v): (lambda m=m, v=v: leafmt_run(*args, v, m))
                         for m in timed for v in VISITS}, rounds, REPS)
    t = {m: tuple(statistics.median(readings[(SERVED_BY.get(m, m), v)])
                  for v in VISITS) for m in MODES}
    return {"launches": launches, "t": t,
            "plain_ms": {m: plain_ms["dma" if _KERNEL_MODE[m] >= 2 else
                                     "pure"] for m in MODES},
            "per_visit": {m: (b - a) / (hi - lo) * 1e6
                          for m, (a, b) in t.items()},
            "hits": {m: int((outs[(m, lo)][1] >= 0).sum()) for m in MODES}}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    tiles = int(argv[1]) if argv[:1] == ["--blocks"] else 1
    dev = card("leafmt_probe")
    r = measure(probe_inputs(tiles, dev))
    lo, hi = VISITS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{tiles} tile(s) of {TILE} rays on {min(tiles, sms)} of {sms} SMs, "
          f"{CLUSTERS} clusters of {WIDTH}; every mode bit-equal to its "
          f"plain version at V={lo} and {hi}; in turns, {ROUNDS} rounds of "
          f"every (mode, V) forward and back, each reading the median of "
          f"{REPS}", flush=True)
    for m in MODES:
        (t_lo, t_hi), per = r["t"][m], r["per_visit"][m]
        served = f"; {SERVED_BY[m]}'s kernel" if m in SERVED_BY else ""
        print(f"  {m:5s}: {per:8.1f} ns/visit ({per / WIDTH:6.2f} ns/tri)   "
              f"[t({lo})={t_lo:.3f} ms t({hi})={t_hi:.3f} ms, plain "
              f"t({lo})={r['plain_ms'][m]:.3f} ms; {r['hits'][m]} rays "
              f"hit{served}]", flush=True)


if __name__ == "__main__":
    main()
