"""The regrouped (demand-packed) leaf phase alone, one window at a time
(K21): the CUDA kernel ``csrc/regroup_probe.cu``, its plain PyTorch
version, and the probe that prices K11's leaf-major flush per (ray, leaf)
pair. The port's counterpart of ``experiments/regroup_probe.py``
(``_kernel``, through ``run_window``).

    python -m tpu_pathtracer_torch.experiments.regroup_probe [upto ...]

A window is K = 64 leaf visits, each with a demand mask over the R = 1024
rays of an (8, 128) tile, packed into S = 1024 (ray, visit) pair slots.
Slot s belongs to the last visit v with ``vpref[v] <= s`` (``vpref`` the
exclusive cumsum of the per-visit demand counts, so a visit with no demand
shares its ``vpref`` with the next and the later one wins) and to the ray
whose exclusive rank in flat (row * 128 + lane) order among visit v's
demanding rays is ``k = s - vpref[v]``. Slots at or past ``vpref[64]`` are
unused: they still take v = 63, k = s - ``vpref[63]``. Each slot tests its
ray against its visit's 64-triangle cluster (Moller-Trumbore, ``cl0`` the
cap); each ray keeps the least t over its slots, the earliest slot on a
tie, the first triangle within a slot. ``upto`` stops early and writes the
TPU kernel's diagnostic outputs (:func:`regroup_window`).

The TPU kernel fetches rays and triangles by one-hot bf16 products on its
MXU (3-term splits, exact). The split reconstructs a normal float32
exactly (``hi + mid + lo == x``; :func:`bf16_split`), so the port reads
the float32 values: the kernel ranks each visit's demand with
``__ballot_sync``, scatters the rays into their slots in shared memory,
tests a slot a thread with the cluster read through L1, and keeps each
ray's winner with a 64-bit shared-memory ``atomicMin`` on (t bits, slot,
triangle). ``vpref`` and ``cids`` are the TPU's SMEM scalars: host tensors
here, passed to the kernel by value.

:func:`regroup_window` dispatches on the device of its rays: CPU tensors go
to the plain version, CUDA tensors to the kernel or the call raises.
``main()`` runs :func:`measure`: every mode held bit-equal to its plain
version on one window and on the TPU file's two repeat counts (4 and 1028
windows, repeated inside one block), timed in turns there; the slope gives
us a window and ns a pair, and one card-wide reading runs 132 x 8 blocks
of one window each.
"""

from __future__ import annotations

import ctypes
import statistics
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.experiments.common import card, in_turns, median_ms
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops.cuda_spheres import _check

S = 1024          # pair slots a window
K = 64            # leaf visits a window
W = 64            # triangles a cluster
R = 1024          # rays a packet: the (8, 128) tile
COMPS = 16        # words a triangle in a cluster row (12 used)
FLT_MAX = float(np.finfo(np.float32).max)
T_MIN = 1e-3
BIG = 1 << 30     # the TPU kernel's "no slot" besti (float 2^30)
UPTOS = ("ct", "g", "ray", "tri", "mt", "full")
WINDOWS = (4, 1028)     # the TPU file's repeat counts (:307-308)
CARD_BLOCKS = 132 * 8   # the card-wide reading: one window a block
# Kernel launches by regroup_window, per mode. Callers reset them to 0 and
# read them back to show that a run went through the kernel.
LAUNCHES = {u: 0 for u in UPTOS}
ROUNDS = 2
REPS = 3


def make_arrays(rng: np.random.Generator, pairs_target: int = 840):
    """The TPU file's ``make_inputs`` (:241-265) without its bf16 split:
    (rays (7, 8, 128) f32 = ox, oy, oz, dx, dy, dz, cl0 = 8; masks (64, 8,
    128) f32; vpref (65,) int32; cids (64,) int32; tri (64, 1024) f32,
    comp-major: word c * 64 + w is component c of triangle w, c = 0-2 v0,
    3-5 e1, 6-8 e2, 9-11 n, 12-15 unused), drawn in its order."""
    o = rng.uniform(-1, 1, (3, 8, 128)).astype(np.float32)
    d = rng.uniform(-1, 1, (3, 8, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    cl0 = np.full((1, 8, 128), 8.0, np.float32)
    p = pairs_target / (K * R)
    m = (rng.uniform(size=(K, 8, 128)) < p).astype(np.float32)
    counts = m.reshape(K, -1).sum(1).astype(np.int64)
    vpref = np.zeros(K + 1, np.int32)
    vpref[1:] = np.cumsum(counts)
    assert vpref[-1] <= S, vpref[-1]
    cids = rng.integers(0, 13000, K).astype(np.int32)
    tri = rng.uniform(-1.5, 1.5, (K, COMPS * W)).astype(np.float32)
    return np.concatenate([o, d, cl0]), m, vpref, cids, tri


def probe_inputs(device="cuda", seed: int = 7) -> Dict[str, torch.Tensor]:
    """The TPU file's inputs from its seed (``default_rng(7)``): rays,
    masks and tri on ``device``; vpref and cids on the host (the kernel's
    scalar operands)."""
    rays, m, vpref, cids, tri = make_arrays(np.random.default_rng(seed))
    dev = lambda a: torch.from_numpy(a).to(device)
    return {"rays": dev(rays), "masks": dev(m), "tri": dev(tri),
            "vpref": torch.from_numpy(vpref), "cids": torch.from_numpy(cids)}


def bf16_split(x: torch.Tensor):
    """The TPU file's 3-term bf16 split (``split3`` :57): (hi, mid, lo),
    bf16, with hi + mid + lo == x for normal float32 values."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


# -------------------------------------------------------- plain version
def slot_table(vpref, masks: torch.Tensor):
    """(v_of [S], k [S], used [S], slot_ray [S], -1 for none): each slot's
    visit, rank and ray, from ``vpref`` (a list) and the demand masks."""
    dev = masks.device
    s = torch.arange(S, device=dev)
    v_of = torch.zeros(S, dtype=torch.int64, device=dev)
    for v in range(K):
        v_of = torch.where(s >= vpref[v], v, v_of)
    vp = torch.tensor(vpref, dtype=torch.int64, device=dev)
    k = s - vp[v_of]
    used = s < vpref[K]
    mm = masks.reshape(K, R) > 0.5
    rank = torch.cumsum(mm.to(torch.int64), 1) - mm.to(torch.int64)
    v_idx, r_idx = mm.nonzero(as_tuple=True)
    slot = vp[v_idx] + rank[v_idx, r_idx]
    ok = (slot < min(S, vpref[K])) & (v_of[slot.clamp(max=S - 1)] == v_idx)
    slot_ray = torch.full((S,), -1, dtype=torch.int64, device=dev)
    slot_ray[slot[ok]] = r_idx[ok]
    return v_of, k, used, slot_ray


def _regroup_ref(rays: torch.Tensor, masks: torch.Tensor, tri: torch.Tensor,
                 vpref: torch.Tensor, cids: torch.Tensor, upto: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One window of ``_kernel`` at ``upto``: (t_out (8, 128) f32, i_out
    (8, 128) int32), as the TPU kernel's ``if upto == ...`` blocks write
    them (:134-226): indexed by slot (ct, ray, tri, mt; g's i_out) or by
    ray (g's t_out, full)."""
    vp, cid = vpref.tolist(), cids.to(torch.int64).to(rays.device)
    v_of, k, used, slot_ray = slot_table(vp, masks)
    cid_s = cid[v_of]
    shape = (8, 128)
    i32 = torch.int32
    if upto == "ct":
        t = cid_s.float() + k.float()
        return t.reshape(shape), torch.where(used, v_of, -1).to(i32).reshape(
            shape)
    if upto == "g":
        owned = torch.zeros(R, dtype=torch.int64, device=rays.device)
        has = slot_ray >= 0
        owned.index_add_(0, slot_ray[has], torch.ones_like(slot_ray[has]))
        return owned.float().reshape(shape), used.to(i32).reshape(shape)
    flat = rays.reshape(7, R)
    has = slot_ray >= 0
    x = torch.where(has, flat[:, slot_ray.clamp(min=0)], 0.0)  # [7, S]
    o1, o2, o3, d1, d2, d3, clp = x
    if upto == "ray":
        return (((o1 + o2) + o3) + clp).reshape(shape), \
            ((d1 + d2) + d3).to(i32).reshape(shape)
    cl = tri.reshape(K, COMPS, W)[v_of]                    # [S, 16, W]
    if upto == "tri":
        t = torch.zeros(S, dtype=torch.float32, device=rays.device)
        for w in range(8):
            t = t + cl[:, 0, w] * 0.5
        return torch.where(used, t, 0.0).reshape(shape), \
            torch.zeros(shape, dtype=i32, device=rays.device)
    rows = cl[:, :12, :].transpose(1, 2)                    # [S, W, 12]
    t, ok = cb.mt_rows(rows, torch.stack([o1, o2, o3], 1),
                       torch.stack([d1, d2, d3], 1), T_MIN, clp)
    tw = torch.where(ok, t, FLT_MAX)
    t_slot = tw.min(dim=1).values
    w_slot = (tw == t_slot[:, None]).to(torch.uint8).argmax(dim=1)
    besti = cid_s * W + w_slot
    if upto == "mt":
        return t_slot.reshape(shape), besti.to(i32).reshape(shape)
    # full: per ray the least (t bits, slot) over its slots
    key = (t_slot.view(torch.int32).to(torch.int64) << 10) | torch.arange(
        S, device=rays.device)
    best = torch.full((R,), 2 ** 62, dtype=torch.int64, device=rays.device)
    best.scatter_reduce_(0, slot_ray[has], key[has], "amin")
    any_slot = best < 2 ** 62
    minv = torch.where(any_slot, (best >> 10).to(torch.int32).view(
        torch.float32), FLT_MAX)
    minb = torch.where(any_slot, besti[best & (S - 1)], BIG)
    clc = flat[6]
    hit = minv < clc
    return torch.where(hit, minv, clc).reshape(shape), \
        torch.where(hit, minb, -1).to(i32).reshape(shape)


def _regroup_plain(inp, upto, windows=1, blocks=1):
    """The plain version of ``windows`` windows on ``blocks`` blocks: the
    window computed ``windows`` times, its outputs repeated a block."""
    for _ in range(max(windows, 1)):
        t, i = _regroup_ref(inp["rays"], inp["masks"], inp["tri"],
                            inp["vpref"], inp["cids"], upto)
    return t.repeat(blocks, 1, 1), i.repeat(blocks, 1, 1)


# --------------------------------------------------------------- wrapper
def _lib() -> ctypes.CDLL:
    lib = _build.load("regroup_probe")
    fn = lib.regroup_probe_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _scalars(vpref: torch.Tensor, cids: torch.Tensor) -> None:
    """Raise unless vpref (65,) and cids (64,) are host int32 with
    vpref[0] = 0, vpref nondecreasing and vpref[64] <= S."""
    for name, a, n in (("vpref", vpref, K + 1), ("cids", cids, K)):
        _check(name, a, torch.device("cpu"), torch.int32, (n,))
    vp = vpref.tolist()
    if vp[0] != 0 or any(b < a for a, b in zip(vp, vp[1:])):
        raise ValueError("vpref must start at 0 and never decrease")
    if vp[K] > S:
        raise ValueError(f"vpref[{K}] = {vp[K]} pairs exceed the {S} slots")


def regroup_window(inp: Dict[str, torch.Tensor], upto: str = "full",
                   windows: int = 1, blocks: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``windows`` repeats of the window ``inp`` (:func:`probe_inputs`'s
    keys) at ``upto`` on each of ``blocks`` blocks: (t_out [blocks, 8, 128]
    f32, i_out [blocks, 8, 128] int32)."""
    if upto not in UPTOS:
        raise ValueError(f"upto must be one of {UPTOS}, not {upto!r}")
    if windows < 1 or blocks < 1:
        raise ValueError("windows and blocks must be >= 1")
    rays, masks, tri = inp["rays"], inp["masks"], inp["tri"]
    dev = rays.device
    if dev.type == "cpu":
        return _regroup_plain(inp, upto, windows, blocks)
    if dev.type != "cuda":
        raise ValueError(f"no regroup kernel for tensors on {dev}")
    _check("rays", rays, dev, torch.float32, (7, 8, 128))
    _check("masks", masks, dev, torch.float32, (K, 8, 128))
    _check("tri", tri, dev, torch.float32, (K, COMPS * W))
    _scalars(inp["vpref"], inp["cids"])
    t = torch.empty((blocks, 8, 128), dtype=torch.float32, device=dev)
    i = torch.empty((blocks, 8, 128), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().regroup_probe_launch(
            UPTOS.index(upto), rays.data_ptr(), masks.data_ptr(),
            tri.data_ptr(), inp["vpref"].data_ptr(), inp["cids"].data_ptr(),
            int(windows), int(blocks), t.data_ptr(), i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"regroup_probe kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES[upto] += 1
    return t, i


# ------------------------------------------------------------ measurement
def measure(inp: Dict[str, torch.Tensor], uptos=UPTOS,
            rounds: int = ROUNDS) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 17 print it). Every mode of ``uptos`` runs on
    one window, at both repeat counts (WINDOWS) and card-wide (one window
    on each of CARD_BLOCKS blocks), each held bit-equal to its plain
    version; then each mode's three runs are timed in turns. Returns
    ``launches`` (LAUNCHES after the checked runs), ``pairs``, ``hits``
    (rays with a winner, full) and by mode: ``t`` ((ms at 4, ms at 1028
    windows), medians of the in-turn readings), ``card_ms`` (the card-wide
    run), ``us_window`` (the slope), ``ns_pair`` (the slope over the
    pairs), ``plain_ms`` (the plain version at 4 windows)."""
    lo, hi = WINDOWS
    runs = {(u, w, b): (lambda u=u, w=w, b=b: regroup_window(inp, u, w, b))
            for u in uptos for w, b in ((1, 1), (lo, 1), (hi, 1),
                                        (1, CARD_BLOCKS))}
    for (u, w, b), fn in runs.items():
        got, want = fn(), _regroup_plain(inp, u, 1, b)
        torch.cuda.synchronize()
        if not all(torch.equal(g, p) for g, p in zip(got, want)):
            raise AssertionError(
                f"regroup {u} at {w} window(s) on {b} block(s): kernel != "
                f"plain on {int((got[0] != want[0]).sum())} t, "
                f"{int((got[1] != want[1]).sum())} i")
    launches = dict(LAUNCHES)
    pairs = int(inp["vpref"][K])
    out = {"launches": launches, "pairs": pairs, "modes": {},
           "hits": int((regroup_window(inp, "full")[1] >= 0).sum())}
    readings = in_turns({k: fn for k, fn in runs.items() if k[1:] != (1, 1)},
                        rounds, REPS)
    for u in uptos:
        t = tuple(statistics.median(readings[(u, w, 1)]) for w in WINDOWS)
        per = (t[1] - t[0]) / (hi - lo)
        out["modes"][u] = {
            "t": t, "card_ms": statistics.median(
                readings[(u, 1, CARD_BLOCKS)]),
            "us_window": per * 1e3, "ns_pair": per * 1e6 / max(pairs, 1),
            "plain_ms": median_ms(lambda u=u: _regroup_plain(inp, u, lo),
                                  reps=2)}
    return out


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    bad = sorted(set(argv) - set(UPTOS))
    if bad:
        sys.exit(f"regroup_probe: no mode {bad}; one of {UPTOS}")
    dev = card("regroup_probe")
    uptos = tuple(u for u in UPTOS if u in argv) or UPTOS
    r = measure(probe_inputs(dev), uptos)
    lo, hi = WINDOWS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{r['pairs']} pairs in {K} visits, {S} slots; {r['hits']} of {R} "
          f"rays hit; every mode bit-equal to its plain version on 1, {lo} "
          f"and {hi} windows (one block, 1 of {sms} SMs) and on "
          f"{CARD_BLOCKS} blocks; in turns, {ROUNDS} rounds forward and "
          f"back, each reading the median of {REPS}", flush=True)
    for u, v in r["modes"].items():
        print(f"  upto={u:4s}: {v['us_window']:8.2f} us/window "
              f"({v['ns_pair']:7.2f} ns/pair)   [t({lo})={v['t'][0]:.3f} ms "
              f"t({hi})={v['t'][1]:.3f} ms; card-wide {CARD_BLOCKS} windows "
              f"{v['card_ms']:.3f} ms = {v['card_ms'] / CARD_BLOCKS * 1e3:.3f}"
              f" us/window; plain t({lo}) {v['plain_ms']:.3f} ms]",
              flush=True)


if __name__ == "__main__":
    main()
