"""What the probes share on the card: the card's line, CUDA-event times,
kernels timed in turns, and the walk telemetry they print.

A probe needs a CUDA device: :func:`card` exits non-zero without one
(the kernels have no CPU mode), and prints the ``nvidia-smi`` name and
power limit first, so every time a probe prints stands beside them.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from typing import Callable, Dict, List

import torch

WARP = 32


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
