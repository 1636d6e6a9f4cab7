"""The shape-cast probe (K26): the CUDA kernel ``csrc/shapecast_probe.cu``,
its plain PyTorch version, and the 15 cases of
``experiments/shapecast_probe.py`` (``CASES``, run by the TPU kernels that
its ``main`` builds).

    python -m tpu_pathtracer_torch.experiments.shapecast_probe

Each case applies reshapes, transposes, slices, broadcasts, a bf16 dot, a
min or an iota to x = ``arange(1024)`` as an (8, 128) float32 tile, and
the kernel writes ``sum(r)`` of the result r into every element of an
(8, 128) tile. On a TPU the probe reports which of these moves Mosaic
accepts; a CUDA kernel indexes memory freely, so that question has no
counterpart on the card, and K26 ports what the cases compute.

:data:`CASES` holds the cases as plain PyTorch functions, under the TPU
file's names and in its order. The two dot cases compute only the
[:8, :128] slice that enters the sum, each entry a sequential float32 sum
of bf16 products over the contraction, as the kernel does. The sum of r
has the kernel's one order (:func:`case_sum`), so the card's result is
bit-equal to the plain version. All sums but the A @ B^T case's are
integers below 2²⁴ and exact in any order; that case sums 1024 squares of
up to ~1.0e6 and its last bits depend on the order.

:func:`shapecast` dispatches on the device of x: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel or the call raises. ``main()``
runs :func:`measure`: every case held bit-equal to its plain version, then
each case's launch and one launch of all 15 timed.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Callable, Dict

import torch

from tpu_pathtracer_torch.experiments.common import card, device_ms, median_ms
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops.cuda_spheres import _check

N = 1024            # elements of x, threads a block
SHAPE = (8, 128)
# Kernel launches by shapecast. Callers reset it to 0 and read it back to
# show that a run went through the kernel.
LAUNCHES = {"cases": 0}
REPS = 7

CASES: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {}


def case(name):
    def deco(fn):
        CASES[name] = fn
        return fn
    return deco


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r[i, j] = sum over k of a[i, k] * b[j, k], added in k order from 0
    in float32 (the kernel's order)."""
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[1]):
        acc = acc + a[:, k, None] * b[None, :, k]
    return acc


@case("reshape (8,128)->(1024,1)")
def _(x):
    return x.reshape(1024, 1) * 2.0


@case("reshape (8,128)->(1,1024)")
def _(x):
    return x.reshape(1, 1024) * 2.0


@case("reshape (1,1024)->(8,128)")
def _(x):
    return (x.reshape(1, 1024) * 1.0).reshape(8, 128)


@case("reshape (1024,1)<-(8,128) via [:,None] of row")
def _(x):
    r = x.reshape(1, 1024)
    return r[0, :][:, None] * 2.0


@case("(1024,1)->(8,128)")
def _(x):
    c = x.reshape(1, 1024)[0, :][:, None] * 1.0
    return c.reshape(8, 128)


@case("transpose (8,128)->(128,8)")
def _(x):
    return x.T * 2.0


@case("transpose (64,1024)")
def _(x):
    y = torch.broadcast_to(x.reshape(1, 1024), (64, 1024)) * 1.0
    return y.T[:128] * 2.0


@case("dot_general lhs-contract-dim0")
def _(x):
    a = _bf16(torch.broadcast_to(x.reshape(1, 1024), (64, 1024)))
    # contract a's dim 0 with b's dim 0 (b = a); only [:8, :128] is kept
    return _dot(a[:, :8].T, a[:, :128].T)


@case("dot_general rhs-contract-dim1 (A @ B^T)")
def _(x):
    a = _bf16(torch.broadcast_to(x.reshape(1, 1024), (256, 1024)))
    return _dot(a[:8], a[:128])


@case("reshape (64,8,128)->(64,1024)")
def _(x):
    y = torch.broadcast_to(x[None], (64, 8, 128)) * 1.0
    return y.reshape(64, 1024)[:8, :128]


@case("reshape (768,1024)->(6144,128) + dim0 slice")
def _(x):
    y = torch.broadcast_to(x.reshape(1, 1024), (768, 1024)) * 1.0
    z = y.reshape(6144, 128)
    return z[8 * 3:8 * 4, :]


@case("broadcast (1024,1)x(1,64)")
def _(x):
    c = x.reshape(1, 1024)[0, :][:, None]
    r = x.reshape(1, 1024)[0, :64][None, :]
    return (c * r)[:8, :128]


@case("column-min (1024,1024)->(1,1024)")
def _(x):
    y = torch.broadcast_to(x.reshape(1, 1024), (1024, 1024)) * 1.0
    return torch.min(y, dim=0, keepdim=True).values.reshape(8, 128)


@case("row-min (1024,64)->(1024,1) + argmin")
def _(x):
    c = x.reshape(1, 1024)[0, :][:, None]
    y = c * torch.ones((1, 64), dtype=torch.float32, device=x.device)
    m = torch.min(y, dim=1, keepdim=True).values
    a = torch.argmin(y, dim=1).to(torch.int32)[:, None]  # the first minimum
    return (m + a.float()).reshape(8, 128)


@case("iota (1024,1024) 2ops build")
def _(x):
    i0 = torch.arange(1024, device=x.device)[:, None]
    i1 = torch.arange(1024, device=x.device)[None, :]
    g = (i0 == i1).to(torch.bfloat16)
    return g[:8, :128].float()


NAMES = tuple(CASES)
# FP32 operations of each case: r's (the * 2.0 products, a dot's products
# and sums over its slice, the row-min case's adds; no compare, no * 1.0)
# and the sum's (an add an element of r, N - 1 to halve the partials)
CASE_FLOPS = tuple(ops + size + N - 1 for ops, size in (
    (1024, 1024), (1024, 1024), (0, 1024), (1024, 1024), (0, 1024),
    (1024, 1024), (8192, 8192), (8 * 128 * 64 * 2, 1024),
    (8 * 128 * N * 2, 1024), (0, 1024), (0, 1024), (512, 512), (0, 1024),
    (1024, 1024), (0, 1024)))


def probe_x(device="cuda") -> torch.Tensor:
    """The TPU file's x: ``arange(1024)`` as an (8, 128) float32 tile."""
    return torch.arange(N, dtype=torch.float32, device=device).reshape(SHAPE)


def case_sum(r: torch.Tensor) -> torch.Tensor:
    """sum(r) in the kernel's order: partial t adds the elements t, t +
    1024, ... of r (row-major) from 0, then the 1024 partials are halved
    pairwise (p[t] + p[t + h], h = 512, ..., 1). A 0-dim float32 tensor."""
    flat = r.reshape(-1).float()
    rows = -(-flat.numel() // N)
    padded = torch.zeros(rows * N, dtype=torch.float32, device=r.device)
    padded[:flat.numel()] = flat
    acc = torch.zeros(N, dtype=torch.float32, device=r.device)
    for row in padded.view(rows, N):
        acc = acc + row
    while acc.numel() > 1:
        h = acc.numel() // 2
        acc = acc[:h] + acc[h:]
    return acc[0]


def shapecast_plain(x: torch.Tensor, first: int = 0,
                    count: int = len(CASES)) -> torch.Tensor:
    """[count, 8, 128]: case first + k's sum in every element of tile k."""
    sums = [case_sum(CASES[NAMES[c]](x)) for c in range(first, first + count)]
    return torch.stack(sums)[:, None, None].expand(count, *SHAPE).contiguous()


# ---------------------------------------------------------------- wrapper
def _lib() -> ctypes.CDLL:
    lib = _build.load("shapecast_probe")
    fn = lib.shapecast_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def shapecast(x: torch.Tensor, first: int = 0,
              count: int = len(CASES)) -> torch.Tensor:
    """K26: cases ``first`` to ``first + count - 1`` on the (8, 128) tile
    ``x``, one block a case: [count, 8, 128], each tile its case's sum."""
    if not (0 <= first and 0 <= count and first + count <= len(CASES)):
        raise ValueError(f"cases {first}..{first + count - 1} are outside "
                         f"0..{len(CASES) - 1}")
    dev = x.device
    if dev.type == "cpu":
        return shapecast_plain(x, first, count)
    if dev.type != "cuda":
        raise ValueError(f"no shapecast kernel for tensors on {dev}")
    _check("x", x, dev, torch.float32, SHAPE)
    out = torch.empty((count, *SHAPE), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().shapecast_launch(x.data_ptr(), int(first), int(count),
                                     out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"shapecast_probe kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["cases"] += 1
    return out


# ------------------------------------------------------------ measurement
def measure(x: torch.Tensor) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 18 print it): every case held bit-equal to its
    plain version, one launch a case and one launch of all 15; then each
    case's launch and the launch of all 15 timed (medians of REPS).
    Returns ``launches`` (LAUNCHES after the checked runs), ``sums`` {name:
    (kernel, plain)}, ``case_ms`` {name: ms}, ``ms`` (all 15; CUDA events
    around the wrapper's call), ``case_device_ms`` and ``device_ms`` (the
    kernel's device time a launch from the profiler, 0 if it reported
    none)
    and ``plain_ms`` (the plain version of all 15, one reading)."""
    every = shapecast(x)
    want = shapecast_plain(x)
    torch.cuda.synchronize()
    sums = {}
    for c, name in enumerate(NAMES):
        one = shapecast(x, c, 1)
        for tag, got in (("alone", one[0]), ("with the others", every[c])):
            if not torch.equal(got, want[c]):
                raise AssertionError(f"K26 {name!r} {tag}: kernel "
                                     f"{got[0, 0].item()!r} != plain "
                                     f"{want[c, 0, 0].item()!r}")
        sums[name] = (one[0, 0, 0].item(), want[c, 0, 0].item())
    launches = dict(LAUNCHES)
    kernel = lambda fn: sum(v for k, v in device_ms(fn, REPS).items()
                            if "shapecast_kernel" in k)
    return {"launches": launches, "sums": sums,
            "case_ms": {name: median_ms(lambda c=c: shapecast(x, c, 1), REPS)
                        for c, name in enumerate(NAMES)},
            "ms": median_ms(lambda: shapecast(x), REPS),
            "case_device_ms": {name: kernel(lambda c=c: shapecast(x, c, 1))
                               for c, name in enumerate(NAMES)},
            "device_ms": kernel(lambda: shapecast(x)),
            "plain_ms": median_ms(lambda: shapecast_plain(x), reps=1)}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv:
        sys.exit(f"shapecast_probe: takes no arguments, not {argv}")
    dev = card("shapecast_probe")
    r = measure(probe_x(dev))
    print(f"all {len(NAMES)} cases bit-equal to their plain versions (alone "
          f"and in one launch); times: CUDA events, median of {REPS}; "
          f"(Mosaic's accept/refuse question has no CUDA counterpart)",
          flush=True)
    print(f"  {'case':46s} {'kernel sum':>14s} {'plain sum':>14s} "
          f"{'us a call':>9s} {'device us':>9s}", flush=True)
    for name, (k, p) in r["sums"].items():
        print(f"  {name:46s} {k:14.1f} {p:14.1f} "
              f"{r['case_ms'][name] * 1e3:9.2f} "
              f"{r['case_device_ms'][name] * 1e3:9.2f}", flush=True)
    print(f"  all {len(NAMES)} cases in one launch: {r['ms'] * 1e3:.2f} us a "
          f"call, {r['device_ms'] * 1e3:.2f} us on the device (0: not "
          f"measured); plain {r['plain_ms']:.2f} ms", flush=True)


if __name__ == "__main__":
    main()
