"""The 8-row node step with its boxes fetched from per-component tables
(K24): the CUDA kernel ``csrc/multirow_probes.cu`` (``walk8_kernel``),
its plain PyTorch version, and the probe that asks whether a row's box
words are cheaper loaded by every lane or loaded once and broadcast by
``__shfl_sync``. The port's counterpart of ``experiments/gather_probe.py``
(``_kernel``, through ``run``).

    python -m tpu_pathtracer_torch.experiments.gather_probe [S ...]

K23's walk (``multirow_probe``) with these differences, the TPU file's:
the 12 box words of node pair p are ``tabs[c].flat[p]`` (c = 0-5 left,
6-11 right) of a (12, S/8, 8, 128) table, S * 128 pairs, which the TPU
reads by two chained per-lane gathers; rows start at ``idx = (r * 37 + 1)
& (128 S - 1)``; the new idx is masked to ``128 S - 1`` (no ``| 1``); the
votes are ``any`` (the same as a count above 0); its ctz goes through the
float exponent (the same as ``__ffs - 1`` below 2^31). Modes, each a fetch
of the kernel: ``lanes`` (every lane loads the row's 12 words) and
``shfl`` (lane i < 12 loads word i, then ``__shfl_sync``).

acc counts misses only (ROADMAP C-19): the checks hold every step's idx
and bs of each row beside it. :func:`gather_run` dispatches on the device
of its rays: CPU tensors go to the plain version, CUDA tensors to the
kernel or the call raises. ``main()`` runs :func:`measure`: both modes at
each S held bit-equal to the plain version (acc and trajectory) at 3
steps and at 1024, then timed in turns at the TPU file's 1024 and 8192
steps; the slope gives ns an 8-row node step.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from tpu_pathtracer_torch.experiments import multirow_probe as mr
from tpu_pathtracer_torch.experiments.common import card
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
    if tabs.dim() != 4:
        raise ValueError(f"tabs must have 4 dimensions, not {tabs.dim()}")
    s = _height(tabs)
    _check("tabs", tabs, dev, torch.float32, (12, s // 8, 8, 128))
    mr.pow2("S", s, 8)
    out = mr.walk8(rays, tabs, s * 128, True, mode, steps, trace)
    LAUNCHES[mode] += 1
    return out


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


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    sizes = tuple(int(a) for a in argv) or SIZES
    dev = card("gather_probe")
    rays, tabs = probe_inputs(sizes, dev)
    r = measure(rays, tabs)
    lo, hi = STEPS
    print(f"both modes at S = {', '.join(map(str, sizes))} bit-equal to the "
          f"plain version (acc and every step's idx and bs) at "
          f"{CHECK_STEPS} and {lo} steps; one block of 8 warps on 1 SM; in "
          f"turns, {mr.ROUNDS} rounds forward and back, each reading the "
          f"median of {mr.REPS}", flush=True)
    for (m, s), v in r["modes"].items():
        print(f"S={s:4d} ({s * 128} node-pairs) {m:5s}: {v['ns']:7.1f} ns "
              f"per 8-row node step   [t({lo})={v['t'][0]:.4f} ms "
              f"t({hi})={v['t'][1]:.4f} ms, plain t({lo}) "
              f"{v['plain_ms']:.3f} ms]", flush=True)


if __name__ == "__main__":
    main()
