"""The sphere layout probe (K25a ``sb``, K25b ``sbf``): the CUDA kernels
``csrc/sphere_layout_probe.cu``, their plain PyTorch versions, and the
probe that asks whether K1's shared-memory tiles cost it time against a
broadcast of the sphere table. The port's counterpart of
``experiments/sphere_layout_probe.py`` (``_kernel_sb`` through ``run_sb``,
``_kernel_sbf`` through ``run_sbf``).

    python -m tpu_pathtracer_torch.experiments.sphere_layout_probe \\
        [parent=FILE.cu]

Rays are a [7, n] float32 tensor (rows ox, oy, oz, dx, dy, dz, t_max), the
TPU file's seven arrays. The sphere table ``sph`` is [4, S] (rows cx, cy,
cz, r²·sign r), padded with r² = −1 slots that never win; ``feat_t`` is
the [n_c, S] feature table, feature-major, zero past the spheres. Both
kernels walk the first ``n_s`` slots in order with the oc-form and a
strict <, so t and idx are bit-equal to K1's (``ops/cuda_spheres.py``),
and give t = FLT_MAX where idx < 0. ``sbf`` fetches the winner's feature
column as the TPU's 3-term split-bf16 one-hot product sums it, lane by
lane: hi = bf16(x), r1 = x − hi, mid = bf16(r1), lo = bf16(r1 − mid),
f = (hi + mid) + lo; 0 on a miss. Like ``run_sbf``, ``sbf`` needs
``n_s`` equal to the table's width S (the TPU's product contracts over
all S slots).

The table must be finite in bf16 (ROADMAP C-20): the TPU's one-hot
product multiplies every slot by 0, so one non-finite value, or one whose
bf16 rounding overflows (|x| near FLT_MAX), turns its feature into NaN for
every ray. The port's gather would not copy that, so it refuses such a
table instead (:func:`check_features`).

On the card the wrapper transposes the table to slot-major [S, 4], the
C entry copies it to constant memory on the launch's stream, and the
kernel takes K1's current form but for where the table lives (its header
says which of the two arms it ships and why; ``sphere_layout_ab.py`` is
their A/B). :func:`spheres_sb` and :func:`spheres_sbf` dispatch on the
device of their rays: CPU tensors go to the plain version, CUDA tensors
to the kernel or the call raises. ``main()`` runs :func:`measure` on the
TPU file's 16,384 rays and on the headline's sets (:func:`frame_sets`:
its 960,000 primary rays of sample 0 and the 32,768-lane pool's, and
their live bounce-2 rays): each kernel held bit-equal to its plain
version and to K1, a ``parent`` source with the same C entry, if given
(say the first form, a thread a ray over every slot: commit 68d9d84's
``csrc/sphere_layout_probe.cu``), to its plain version, then all timed
in turns with K1, device time a call in a CUDA graph. (The TPU file chains
its timed steps by moving ``ox`` by t·1e-9, which a miss's t = FLT_MAX
moves by ~3.4e29; that chain is not ported.) K1 walks the 486 spheres,
K25 all 512 slots, so K25 does 5% more pair tests.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine import wavefront as wf
from tpu_pathtracer_torch.experiments.common import (build, card,
                                                    graph_rounds, median_ms,
                                                    sphere_pairs)
from tpu_pathtracer_torch.experiments.spheres_mx_ab import ray_sets
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops.cuda_spheres import _check
from tpu_pathtracer_torch.ops.v3 import V3

ROWS = 8            # the TPU's (8, 128) ray tile
S = 512             # the table's slots
M = 1 << 14         # the TPU file's rays
N_C = 18            # features: centre, radius, 14 ones
FLT_MAX = float(np.finfo(np.float32).max)
T_MIN = 1e-3
SEED = 0            # the rays' np.random.RandomState
HEADLINE = (1200, 800)  # the headline's frame: 960,000 primary rays
# Kernel launches by spheres_sb and spheres_sbf. Callers reset them to 0
# and read them back to show that a run went through the kernels.
LAUNCHES = {"sb": 0, "sbf": 0}
KERNEL_ID = {"sb": "K25a", "sbf": "K25b"}
ROUNDS = 3


# ------------------------------------------------------------------ inputs
def ray_arrays(m: int = M, seed: int = SEED) -> Tuple[np.ndarray, np.ndarray]:
    """(o [3, m], d [3, m]) float32, drawn in the TPU file's order
    (:193-197): origins uniform in [-8, 8]³ lifted by 10 in y, directions
    normal and normalised."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-8, 8, (3, m)).astype(np.float32)
    o[1] += 10
    d = rng.randn(3, m).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def sphere_table(centers: torch.Tensor, radii: torch.Tensor,
                 s: int = S) -> torch.Tensor:
    """[4, s] rows cx, cy, cz, r²·sign r of the ns <= s spheres, the slots
    past them r² = −1 (the TPU file's encoding, :186-190)."""
    ns = centers.shape[0]
    if ns > s:
        raise ValueError(f"{ns} spheres do not fit {s} slots")
    tab = torch.zeros((4, s), dtype=torch.float32, device=centers.device)
    tab[:3, :ns] = centers.t()
    tab[3, :ns] = radii * radii * torch.where(radii > 0, 1.0, -1.0)
    tab[3, ns:] = -1.0
    return tab


def feature_rows(centers: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """[ns, 18]: centre, radius and 14 ones (the TPU file's ``feat``,
    :200-201)."""
    ones = torch.ones((centers.shape[0], N_C - 4), dtype=torch.float32,
                      device=centers.device)
    return torch.cat([centers, radii[:, None], ones], dim=1)


def feature_table(feat: torch.Tensor, s: int = S) -> torch.Tensor:
    """[n_c, s]: ``feat`` [ns, n_c] transposed, zero past the spheres."""
    ns, n_c = feat.shape
    out = torch.zeros((n_c, s), dtype=torch.float32, device=feat.device)
    out[:, :ns] = feat.t()
    return out


def _inputs(o: V3, d: V3, centers, radii) -> Dict[str, torch.Tensor]:
    tmax = torch.full_like(o.x, FLT_MAX)
    feat = feature_rows(centers, radii)
    return {"rays": torch.stack([*o, *d, tmax]).contiguous(),
            "sph": sphere_table(centers, radii),
            "feat": feat, "feat_t": feature_table(feat),
            "centers": centers, "radii": radii}


def probe_inputs(device="cuda", m: int = M) -> Dict[str, torch.Tensor]:
    """The TPU file's inputs on ``device``: ``rays`` [7, m] (its draw
    order, t_max = FLT_MAX), ``sph`` [4, S] and ``feat_t`` [18, S] of the
    headline's 486 spheres (``random_spheres_scene(1200, 800)``), and, for
    K1, ``feat`` [486, 18], ``centers`` [486, 3] and ``radii``."""
    scene, _ = random_spheres_scene(*HEADLINE, device=device)
    o, d = (V3(*(torch.from_numpy(a[k]).to(device) for k in range(3)))
            for a in ray_arrays(m))
    return _inputs(o, d, scene.sphere_center, scene.sphere_radius)


def frame_sets(device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """:func:`probe_inputs`' keys for the headline's four sets of
    ``spheres_mx_ab.ray_sets``: the pool's primary rays and the 960,000
    primary rays of sample 0, and the live rays of each one's second
    bounce (t_max = FLT_MAX)."""
    nx, ny = HEADLINE
    cfg = RenderConfig(nx=nx, ny=ny, ns=100, max_depth=50)
    scene, cam = random_spheres_scene(nx, ny, device=device)
    view = wf.make_view(scene, cfg)
    return {name: _inputs(o, d, scene.sphere_center, scene.sphere_radius)
            for name, (o, d) in ray_sets(scene, cam, cfg, view).items()}


# ---------------------------------------------------------- plain versions
def sb_plain(rays: torch.Tensor, sph: torch.Tensor, t_min: float = T_MIN,
             n_s: int = S) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_kernel_sb``: (t [n], idx [n] int32) over the first ``n_s`` slots
    of ``sph`` [4, s], slot by slot in the kernel's operation order."""
    o1, o2, o3, d1, d2, d3, t_best = rays
    i_best = torch.full_like(o1, -1, dtype=torch.int32)
    for s in range(n_s):
        ccx, ccy, ccz, rr2 = sph[:, s]
        ocx = o1 - ccx
        ocy = o2 - ccy
        ocz = o3 - ccz
        b = ocx * d1 + ocy * d2 + ocz * d3
        c = ocx * ocx + ocy * ocy + ocz * ocz - rr2
        disc = b * b - c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1 = -b - sq
        t2 = -b + sq
        ts0 = torch.where(t1 > t_min, t1, t2)
        win = (disc > 0.0) & (ts0 > t_min) & (ts0 < t_best)
        t_best = torch.where(win, ts0, t_best)
        i_best = torch.where(win, s, i_best)
    return torch.where(i_best >= 0, t_best, FLT_MAX), i_best


def bf16_sum(x: torch.Tensor) -> torch.Tensor:
    """(hi + mid) + lo of the 3-term bf16 split of ``x``: the one-hot
    product's sum for one slot (``x`` itself where x is finite in bf16)."""
    bf = lambda v: v.to(torch.bfloat16).float()
    hi = bf(x)
    r1 = x - hi
    mid = bf(r1)
    lo = bf(r1 - mid)
    return (hi + mid) + lo


def sbf_plain(rays: torch.Tensor, sph: torch.Tensor, feat_t: torch.Tensor,
              t_min: float = T_MIN):
    """``_kernel_sbf``: (t, idx, f [n_c, n]) over all slots of ``sph``,
    the winner's feature column by :func:`bf16_sum`, 0 on a miss."""
    t, idx = sb_plain(rays, sph, t_min, sph.shape[1])
    f = bf16_sum(feat_t[:, idx.clamp_min(0).long()])
    return t, idx, torch.where(idx >= 0, f, 0.0)


def check_features(feat_t: torch.Tensor) -> None:
    """Raise ValueError unless every value of ``feat_t`` is finite in bf16
    (C-20: the TPU's one-hot product turns a feature with a non-finite
    slot into NaN for every ray). On the card this reads one flag back."""
    if not bool(torch.isfinite(feat_t.to(torch.bfloat16)).all()):
        raise ValueError("feat_t must be finite in bf16 (|x| below ~3.39e38,"
                         " no inf or NaN): the TPU's one-hot fetch turns such"
                         " a feature into NaN for every ray (ROADMAP C-20)")


# --------------------------------------------------------------- wrappers
def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (the package's build or another source's) with
    ``sphere_layout_launch``'s signature set."""
    fn = lib.sphere_layout_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 8 + [i, p, i, i, ctypes.c_float] + [p] * 4
        fn.restype = ctypes.c_int
    return lib


def source_lib(path: Path, out: Optional[Path] = None) -> ctypes.CDLL:
    """Another source of the kernel with the same C entry (a parent),
    built by ``common.build`` and bound; ``out`` keeps its ptxas lines
    and SASS."""
    lib, _ = build("sphere_layout_parent", Path(path).read_text(), out)
    return bind(ctypes.CDLL(str(lib)))


def slot_major(sph: torch.Tensor) -> torch.Tensor:
    """[S, 4]: the [4, S] table transposed, a slot's 16 B together (what
    the C entry copies to constant memory)."""
    return sph.t().contiguous()


def _launch(mode: str, rays, tab, t_min, n_s, feat_t=None,
            lib: Optional[ctypes.CDLL] = None):
    """One launch on slot-major ``tab`` [S, 4] through ``lib`` (default:
    the package's build, counted in LAUNCHES; another library's are not
    counted): the table's copy to constant memory, then the kernel."""
    dev = rays.device
    n = rays.shape[1]
    f32 = torch.float32
    _check("rays", rays, dev, f32, (7, n))
    _check("tab", tab, dev, f32, (S, 4))
    if not 0 <= n_s <= S:
        raise ValueError(f"n_s = {n_s} is outside [0, {S}]")
    n_c = 0
    if feat_t is not None:
        n_c = feat_t.shape[0]
        _check("feat_t", feat_t, dev, f32, (n_c, S))
    t = torch.empty(n, dtype=f32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    f = None if feat_t is None else torch.empty((n_c, n), dtype=f32,
                                                device=dev)
    ptr = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = (lib or bind(_build.load("sphere_layout_probe"))
              ).sphere_layout_launch(
            int(feat_t is not None), *(rays[k].data_ptr() for k in range(7)),
            tab.data_ptr(), int(n_s), ptr(feat_t), n_c, n,
            float(t_min), t.data_ptr(), idx.data_ptr(), ptr(f), stream)
    if rc != 0:
        raise RuntimeError(f"sphere_layout_probe {mode} launch failed: CUDA "
                           f"error {rc}")
    if lib is None:
        LAUNCHES[mode] += 1
    return t, idx, f


def _on_cuda(rays: torch.Tensor) -> bool:
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sphere layout kernel for tensors on "
                         f"{rays.device}")
    return rays.device.type == "cuda"


def spheres_sb(rays: torch.Tensor, sph: torch.Tensor, t_min: float = T_MIN,
               n_s: int = S) -> Tuple[torch.Tensor, torch.Tensor]:
    """K25a: the nearest hit over the first ``n_s`` slots of ``sph``:
    (t [n] with FLT_MAX on a miss, idx [n] int32, −1 on a miss). On the
    card ``sph`` is [4, S]."""
    if _on_cuda(rays):
        _check("sph", sph, rays.device, torch.float32, (4, S))
        return _launch("sb", rays, slot_major(sph), t_min, n_s)[:2]
    return sb_plain(rays, sph, t_min, n_s)


def spheres_sbf(rays: torch.Tensor, sph: torch.Tensor, feat_t: torch.Tensor,
                t_min: float = T_MIN, checked: bool = False):
    """K25b: :func:`spheres_sb` over every slot of ``sph``, plus the
    winner's feature column: (t, idx, f [n_c, n], 0 on a miss). The table
    is checked by :func:`check_features` unless ``checked`` says the
    caller did (the check reads a flag back from the card)."""
    if feat_t.shape[1] != sph.shape[1]:
        raise ValueError(f"feat_t has {feat_t.shape[1]} slots, sph "
                         f"{sph.shape[1]}: sbf walks every slot of both")
    if not checked:
        check_features(feat_t)
    if _on_cuda(rays):
        _check("sph", sph, rays.device, torch.float32, (4, S))
        return _launch("sbf", rays, slot_major(sph), t_min, sph.shape[1],
                       feat_t)
    return sbf_plain(rays, sph, feat_t, t_min)


# ------------------------------------------------------------ measurement
def _v3s(rays):
    return V3(*rays[:3]), V3(*rays[3:6])


def _k1(inp, nearest: bool = False):
    """K1 (``spheres_hit_feat``, kFeatures; ``nearest``: K1b,
    ``spheres_hit_soa``) on the same rays and spheres, with the sphere
    table built once as the frame's view holds it (``inp["k1_tab"]``,
    made on first use): (t, idx[, a tuple of 18 [n] features])."""
    o, d = _v3s(inp["rays"])
    c = V3(*inp["centers"].t())
    if "k1_tab" not in inp:
        inp["k1_tab"] = cs.sphere_table(c, inp["radii"])
    if nearest:
        return cs.spheres_hit_soa(o, d, c, inp["radii"], T_MIN,
                                  inp["rays"][6], tab=inp["k1_tab"])
    return cs.spheres_hit_feat(o, d, c, inp["radii"], inp["feat"], T_MIN,
                               inp["rays"][6], tab=inp["k1_tab"])


def _equal(tag, got, want):
    for name, g, w in zip(("t", "idx", "f"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{tag}: {name} differs on "
                                 f"{int((g != w).sum())} of {g.numel()}")


def calls(inp, lib: Optional[ctypes.CDLL] = None):
    """{"sb": ..., "sbf": ...}: K25a's and K25b's launch on ``inp`` through
    ``lib`` (default: the package's build), as :func:`_launch` takes them,
    on the slot-major table built once (``inp["tab"]``)."""
    if "tab" not in inp:
        inp["tab"] = slot_major(inp["sph"])
    rays, tab = inp["rays"], inp["tab"]
    return {"sb": lambda: _launch("sb", rays, tab, T_MIN, S, None, lib)[:2],
            "sbf": lambda: _launch("sbf", rays, tab, T_MIN, S, inp["feat_t"],
                                   lib)}


def check(name, inp, fns) -> dict:
    """Holds K25a's and K25b's outputs (``fns``: :func:`calls`) bit-equal
    to their plain versions and to K1 (t and idx; K25b's f to K1's
    features, 0 on a miss). Returns the plain outputs."""
    rays, sph, feat_t = inp["rays"], inp["sph"], inp["feat_t"]
    want = {"sb": sb_plain(rays, sph), "sbf": sbf_plain(rays, sph, feat_t)}
    k1 = _k1(inp)
    for mode, fn in fns.items():
        got = fn()
        _equal(f"{KERNEL_ID[mode]} {name} vs plain", got, want[mode])
        _equal(f"{KERNEL_ID[mode]} {name} vs K1", got,
               (*k1[:2], torch.stack(k1[2])) if mode == "sbf" else k1[:2])
    return want


def measure(sets: Dict[str, Dict[str, torch.Tensor]],
            rounds: int = ROUNDS,
            parent: Optional[ctypes.CDLL] = None) -> dict:
    """The probe's one measurement, on the card (``main()`` and
    ``chip_smoke.py`` phase 18 print it). For each set of inputs (keys of
    :func:`probe_inputs`): the table checked once (C-20); K25a and K25b
    held bit-equal to their plain versions (t, idx, f) and to K1
    (:func:`check`), ``parent`` (:func:`source_lib`), if given, to the
    plain versions too; then timed in turns, device time a call in a CUDA
    graph (``common.graph_rounds``, ``rounds`` rounds): ``sb`` and ``sbf``
    (the table's copy to constant memory and the kernel, as the wrapper
    launches them), ``copy`` (the C entry on no rays: the table's copy
    alone), the parent's calls (``parent sb``, ``parent sbf``) and K1
    (``k1``: features, ``k1b``: t and idx, the table built once, as the
    frame calls them).
    Returns ``launches`` (LAUNCHES after the checked runs) and by set:
    ``n``, ``hits``, ``pairs`` and ``disc_pairs`` (the ray-slot pairs
    over every slot and those with disc > 0), ``ms`` by name and
    ``plain_ms`` {sb, sbf} (one reading each)."""
    out = {"sets": {}}
    for name, inp in sets.items():
        check_features(inp["feat_t"])
        want = check(name, inp, calls(inp))
        # the timed calls go through the library itself: LAUNCHES keeps
        # the checked runs' count
        lib = bind(_build.load("sphere_layout_probe"))
        fns = {**calls(inp, lib),
               "copy": lambda inp=inp, lib=lib: _launch(
                   "sb", inp["rays"][:, :0], inp["tab"], T_MIN, S, None, lib),
               "k1": lambda inp=inp: _k1(inp),
               "k1b": lambda inp=inp: _k1(inp, nearest=True)}
        if parent is not None:
            for mode, fn in calls(inp, parent).items():
                _equal(f"parent {mode} {name} vs plain", fn(),
                       want[mode])
                fns[f"parent {mode}"] = fn
        torch.cuda.synchronize()
        names = list(fns)
        ms = {k: v for (k, _), v in graph_rounds(
            names, [None], lambda k, _: fns[k](), rounds).items()}
        rays, sph, feat_t = inp["rays"], inp["sph"], inp["feat_t"]
        o, d = _v3s(rays)
        pairs, disc = sphere_pairs(o, d, inp["tab"], T_MIN, rays[6])
        out["sets"][name] = {
            "n": rays.shape[1], "hits": int((want["sb"][1] >= 0).sum()),
            "pairs": pairs, "disc_pairs": disc, "ms": ms,
            "plain_ms": {
                "sb": median_ms(lambda: sb_plain(rays, sph), reps=1),
                "sbf": median_ms(lambda: sbf_plain(rays, sph, feat_t),
                                 reps=1)}}
    out["launches"] = dict(LAUNCHES)
    return out


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    parent = [a.split("=", 1)[1] for a in argv if a.startswith("parent=")]
    if len(parent) != len(argv) or len(parent) > 1:
        sys.exit(f"sphere_layout_probe: takes [parent=FILE.cu], not {argv}")
    dev = card("sphere_layout_probe")
    r = measure({"tpu": probe_inputs(dev), **frame_sets(dev)},
                parent=source_lib(parent[0]) if parent else None)
    print(f"K25a, K25b bit-equal to their plain versions and to K1 (t, idx; "
          f"features where idx >= 0, 0 elsewhere), the parent, if given, to "
          f"the plain versions, on every set; device time a call in a CUDA "
          f"graph, median of {ROUNDS} rounds in turns (sb, sbf: the table's "
          f"copy and the kernel; copy: the copy alone); K1 walks 486 "
          f"spheres, K25 {S} slots", flush=True)
    for name, v in r["sets"].items():
        print(f"  {name}: {v['n']} rays, {v['hits']} hits, {v['pairs']} "
              f"pairs, {v['disc_pairs']} with disc > 0: " + ", ".join(
                  f"{k} {ms:.4f}" for k, ms in v["ms"].items())
              + f" ms; plain sb {v['plain_ms']['sb']:.2f} ms, sbf "
              f"{v['plain_ms']['sbf']:.2f} ms", flush=True)


if __name__ == "__main__":
    main()
