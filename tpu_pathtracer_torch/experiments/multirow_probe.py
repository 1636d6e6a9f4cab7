"""A synthetic node step of the 8-row packet (K23): the CUDA kernel
``csrc/multirow_probes.cu`` (``walk8_kernel``), its plain PyTorch
version, and the probe that prices K12a's node round (a vote and a
warp-uniform advance) against K5's per-lane step. The port's counterpart
of ``experiments/multirow_probe.py`` (``_kernel``, through ``run``); the
8-row walk it shares with K24 (``gather_probe``) and the library of both
and of K22 (``leafround_probe``) live here.

    python -m tpu_pathtracer_torch.experiments.multirow_probe [N]

Eight rows of 128 ray lanes walk on their own. A step reads the left and
right boxes of the row's node pair (12 words), runs two slab tests a lane,
votes over the row's lanes (pref = sum of +-1 over lanes inside both boxes,
nearer right box +1; nl, nr the lanes in each) and advances the row's
bitstack: into both children (the preferred one first), into the one hit,
or pops (ctz of the bitstack). ``acc += lhit + rhit`` a lane. Modes:
``fixed`` (constant boxes: slab, vote and advance alone) and ``assemble``
(the boxes of pair idx from the flat table ``ntab``, words 12 idx to 12
idx + 11; on the card one load a word, broadcast by ``__shfl_sync``).

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
import statistics
import sys
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.experiments.common import card, event_ms, in_turns
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
REPS = 3

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


def _lib() -> ctypes.CDLL:
    """``csrc/multirow_probes.cu``: K22's and the walk's launchers."""
    lib = _build.load("multirow_probes")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("leafround_probe_launch", [i, i, p, p, i, p, p]),
                       ("walk8_probe_launch", [i, i, p, p, i, i, p, p, p,
                                               p])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def device_of(steps: int, *tensors: torch.Tensor) -> torch.device:
    """The inputs' one device, CPU or CUDA; steps >= 0."""
    if steps < 0:
        raise ValueError(f"steps must be >= 0, not {steps}")
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
          fetch: str, steps: int, trace: bool) -> Walk:
    """Launch the 8-row walk on the card; (acc, idx, bs), the last two
    None unless ``trace``."""
    dev = rays.device
    _check("rays", rays, dev, torch.float32, (7, ROWS, LANES))
    acc = torch.empty((ROWS, LANES), dtype=torch.float32, device=dev)
    tr = [torch.empty((steps, ROWS), dtype=torch.int32, device=dev)
          for _ in range(2)] if trace else [None, None]
    ptr = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().walk8_probe_launch(int(pairs), FETCH[fetch],
                                       rays.data_ptr(), tab.data_ptr(),
                                       words, int(steps), acc.data_ptr(),
                                       ptr(tr[0]), ptr(tr[1]), stream)
    if rc != 0:
        raise RuntimeError(f"walk8 {fetch} launch failed: CUDA error {rc}")
    return acc, tr[0], tr[1]


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
    n = ntab.numel() // 6
    _check("ntab", ntab, dev, torch.float32, (n * 6,))
    pow2("N", n, 32)
    out = walk8(rays, ntab, n, False, mode, steps, trace)
    LAUNCHES[mode] += 1
    return out


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
    """Time ``fns`` (by key, ``fn(steps)``) in turns at lo and hi steps:
    by key ``t`` ((ms lo, ms hi), medians of the in-turn readings),
    ``ns`` (the slope: ns a step) and ``plain_ms`` (``plain_ms[key]``,
    the plain version at lo)."""
    readings = in_turns({(k, s): (lambda f=f, s=s: f(s))
                         for k, f in fns.items() for s in (lo, hi)},
                        rounds, REPS)
    out = {}
    for k in fns:
        t = tuple(statistics.median(readings[(k, s)]) for s in (lo, hi))
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
    n = int(argv[0]) if argv else N
    dev = card("multirow_probe")
    ntab, rays = probe_inputs(n, dev)
    r = measure(ntab, rays)
    lo, hi = STEPS
    print(f"N={n}: both modes bit-equal to their plain versions (acc and "
          f"every step's idx and bs) at {CHECK_STEPS} and {lo} steps; one "
          f"block of 8 warps on 1 SM; in turns, {ROUNDS} rounds forward and "
          f"back, each reading the median of {REPS}", flush=True)
    for m, v in r["modes"].items():
        print(f"{m:9s}: {v['ns']:7.1f} ns per 8-row node step   "
              f"[t({lo})={v['t'][0]:.4f} ms t({hi})={v['t'][1]:.4f} ms, "
              f"plain t({lo}) {v['plain_ms']:.3f} ms]", flush=True)


if __name__ == "__main__":
    main()
