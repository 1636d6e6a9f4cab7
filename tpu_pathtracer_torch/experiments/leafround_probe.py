"""One leaf round of the 8-row packet (K22): the CUDA kernel
``csrc/multirow_probes.cu`` (``leafround_kernel``), its plain PyTorch
version, and the probe that prices K12a's leaf round, 8 rows each against
its own cluster, against K5's per-ray leaf visit. The port's counterpart
of ``experiments/leafround_probe.py`` (``_kernel``, through ``run``).

    python -m tpu_pathtracer_torch.experiments.leafround_probe \
        [--mode M] [w ...]

Eight rows of 128 ray lanes (origins and directions standard normal, the
directions not normalized). A round: row r tests its lanes against the w
triangles of cluster ``ids[r]`` of 1024 (word c * w + j of a cluster's
(16 w / 128, 128) block is component c of triangle j: v0, e1, e2, n), a
strict-less nearest update of closest (from 1e30, t > 1e-3), then ``ids =
(ids * 5 + 1 + (bits(closest[r, 0]) & 1)) & 1023``, starting at ``(r * 37
+ 1) & 1023``. ``mode`` (the TPU file's ``LEAF_MODE``, an argument here)
adds the steps of the round one at a time: 0 the MT loop alone, 1 the ids'
round trip out of the lanes (on the card: through shared memory and a
barrier), 2 the 8 cluster fetches (on the card: each row stages its
cluster into shared memory with coalesced loads, and the MT loop reads its
words as broadcasts).

Finding ROADMAP C-18: in modes 0 and 1 the TPU kernel's MT loop reads a
VMEM scratch (``leafround_probe.py:120``) that only mode 2 writes
(``:55-64``), so on a TPU its result is whatever the scratch held; in
interpret mode every lane misses. The port zero-fills the cluster slots
once, which gives that all-miss result: closest stays 1e30.

:func:`leafround_run` dispatches on the device of its rays: CPU tensors go
to the plain version, CUDA tensors to the kernel or the call raises.
``main()`` runs :func:`measure`: every mode at each width held bit-equal
to its plain version at 3 rounds and at 256, then timed in turns at the
TPU file's 256 and 2048 rounds; the slope gives ns an 8-row leaf round.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_pathtracer_torch.experiments import multirow_probe as mr
from tpu_pathtracer_torch.experiments.common import card, event_ms
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops.cuda_spheres import _check

C = 1024                  # clusters in the synthetic mesh
WIDTHS = (32, 64)         # the TPU file's default widths
MODES = (0, 1, 2)         # LEAF_MODE: MT only, + ids, + fetch
ROUNDS_PAIR = (256, 2048)  # the TPU file's slope points (:30)
CHECK_STEPS = mr.CHECK_STEPS
T_MIN = 1e-3
# Kernel launches by leafround_run, per mode. Callers reset them to 0 and
# read them back to show that a run went through the kernel.
LAUNCHES = {m: 0 for m in MODES}


def probe_inputs(widths=WIDTHS, device="cuda"):
    """The TPU file's inputs from its seed (``default_rng(0)``): (rays (7,
    8, 128) f32, {w: blocks (1024, 16 w / 128, 128) f32}), all standard
    normal, drawn in its order (the rays, then the blocks of each width in
    turn)."""
    rng = np.random.default_rng(0)
    rays = rng.standard_normal((7, mr.ROWS, mr.LANES)).astype(np.float32)
    blocks = {w: rng.standard_normal((C, max(16 * w // 128, 1), 128)).astype(
        np.float32) for w in widths}
    dev = lambda a: torch.from_numpy(a).to(device)
    return dev(rays), {w: dev(b) for w, b in blocks.items()}


def _width(blocks: torch.Tensor) -> int:
    return blocks.shape[1] * 128 // 16


def _leafround_ref(rays: torch.Tensor, blocks: torch.Tensor, rounds: int,
                   mode: int, ids_trail: Optional[List[torch.Tensor]] = None
                   ) -> torch.Tensor:
    """closest (8, 128) after ``rounds`` rounds; ``ids_trail`` collects
    each round's cluster ids [8]."""
    w = _width(blocks)
    dev = rays.device
    o = rays[:3].reshape(3, -1).T
    d = rays[3:6].reshape(3, -1).T
    ids = (torch.arange(mr.ROWS, device=dev) * 37 + 1) & (C - 1)
    closest = torch.full((mr.TILE,), mr.FAR, dtype=torch.float32, device=dev)
    lane_row = torch.arange(mr.TILE, device=dev) // mr.LANES
    zero = torch.zeros((mr.TILE, w, 12), dtype=torch.float32, device=dev)
    for _ in range(rounds):
        if ids_trail is not None:
            ids_trail.append(ids)
        if mode >= 2:
            cl = blocks[ids].reshape(mr.ROWS, -1)[:, :12 * w]
            rows = cl.reshape(mr.ROWS, 12, w).transpose(1, 2)[lane_row]
        else:
            rows = zero  # the unwritten scratch, zero-filled (C-18)
        t, ok = cb.mt_rows(rows, o, d, T_MIN, closest)
        tmin = torch.where(ok, t, float("inf")).min(dim=1).values
        closest = torch.where(ok.any(dim=1), tmin, closest)
        dep = closest.view(torch.int32)[::mr.LANES].to(torch.int64) & 1
        ids = (ids * 5 + 1 + dep) & (C - 1)
    return closest.reshape(mr.ROWS, mr.LANES)


def leafround_run(rays: torch.Tensor, blocks: torch.Tensor, rounds: int,
                  mode: int = 2) -> torch.Tensor:
    """K22: ``rounds`` leaf rounds of the 8 rows of ``rays`` ((7, 8, 128)
    f32) over ``blocks`` ((1024, 16 w / 128, 128) f32, w = 32 or 64) in
    LEAF_MODE ``mode``: closest (8, 128), 1e30 where no triangle hit."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    dev = mr.device_of(rounds, rays, blocks)
    if dev.type == "cpu":
        return _leafround_ref(rays, blocks, rounds, mode)
    if blocks.dim() != 3:
        raise ValueError(f"blocks must have 3 dimensions, not {blocks.dim()}")
    w = _width(blocks)
    if w not in WIDTHS:
        raise ValueError(f"the kernel takes widths {WIDTHS}, not {w}")
    _check("rays", rays, dev, torch.float32, (7, mr.ROWS, mr.LANES))
    _check("blocks", blocks, dev, torch.float32, (C, 16 * w // 128, 128))
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned (float4)")
    out = torch.empty((mr.ROWS, mr.LANES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = mr._lib().leafround_probe_launch(mode, w, rays.data_ptr(),
                                              blocks.data_ptr(), int(rounds),
                                              out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"leafround mode {mode} launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES[mode] += 1
    return out


def measure(rays: torch.Tensor, blocks: Dict[int, torch.Tensor],
            modes=MODES, rounds: int = mr.ROUNDS) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 17 print it): every mode at every width of
    ``blocks`` held bit-equal to its plain version at CHECK_STEPS and
    ROUNDS_PAIR[0] rounds, then all timed in turns at ROUNDS_PAIR.
    Returns ``launches`` (LAUNCHES after the checked runs), ``hits`` (by
    width, lanes with a hit after ROUNDS_PAIR[0] rounds of mode 2) and by
    (mode, w) ``t``, ``ns`` (ns a round) and ``plain_ms`` (the checked
    plain run at ROUNDS_PAIR[0]; modes 0 and 1 share it;
    ``multirow_probe.slopes``)."""
    lo, hi = ROUNDS_PAIR
    fn_of = lambda m: 0 if m < 2 else 2  # modes 0 and 1 compute one function
    hits, plain_ms = {}, {}
    for w, b in blocks.items():
        for n in (CHECK_STEPS, lo):
            for f in sorted({fn_of(m) for m in modes}):
                res = []
                ms = event_ms(
                    lambda: res.append(_leafround_ref(rays, b, n, f)))
                want = res[0]
                for m in modes:
                    if fn_of(m) != f:
                        continue
                    got = leafround_run(rays, b, n, m)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"leafround mode {m} w={w} at {n} rounds: "
                            f"kernel != plain on {int((got != want).sum())} "
                            f"lanes")
                    plain_ms[(m, w)] = ms
                if f == 2 and n == lo:
                    hits[w] = int((want < mr.FAR).sum())
    launches = dict(LAUNCHES)
    out = mr.slopes({(m, w): (lambda n, m=m, b=b: leafround_run(rays, b, n, m))
                     for w, b in blocks.items() for m in modes},
                    plain_ms, lo, hi, rounds)
    return {"launches": launches, "hits": hits, "modes": out}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    modes = MODES
    if argv[:1] == ["--mode"]:
        modes, argv = (int(argv[1]),), argv[2:]
    widths = tuple(int(a) for a in argv) or WIDTHS
    dev = card("leafround_probe")
    rays, blocks = probe_inputs(widths, dev)
    r = measure(rays, blocks, modes)
    lo, hi = ROUNDS_PAIR
    print(f"modes {modes} at w = {widths} bit-equal to their plain versions "
          f"at {CHECK_STEPS} and {lo} rounds; one block of 1024 threads on 1 "
          f"SM; in turns, {mr.ROUNDS} rounds forward and back, each reading "
          f"the median of {mr.REPS}; lanes hit after {lo} rounds of mode 2: "
          f"{r['hits']}", flush=True)
    for (m, w), v in r["modes"].items():
        print(f"w={w:4d} mode={m}: {v['ns']:8.1f} ns per 8-row leaf round   "
              f"[t({lo})={v['t'][0]:.4f} ms t({hi})={v['t'][1]:.4f} ms, "
              f"plain t({lo}) {v['plain_ms']:.3f} ms]", flush=True)


if __name__ == "__main__":
    main()
