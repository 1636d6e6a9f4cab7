"""A/B of the mx sphere kernel's sources on the card (K2 nearest +
features, K3 any-hit): ``csrc/spheres_mx.cu`` against other sources of its
C entry, on the random-spheres headline's ray sets, in turns with K1/K1c.

    git show <commit>:tpu_pathtracer_torch/csrc/spheres_mx.cu > <dir>/parent.cu
    python -m tpu_pathtracer_torch.experiments.spheres_mx_ab \\
        parent=<dir>/parent.cu [NAME=K:V,K:V ...] [--out DIR]

``NAME=PATH`` adds a source (the first one given is the baseline of the
factors); ``NAME=K:V,...`` adds a variant of ``csrc/spheres_mx.cu`` with
its ``constexpr int K`` set to V. ``new`` is ``csrc/spheres_mx.cu`` as it
stands. A source that sums the split products on the tensor cores (its
text holds ``mma.sync.aligned``) takes the table of ``cuda_spheres.mx_operands``
and is held to the plain version by the bound
(``cuda_spheres.mx_nearest_departures`` and ``mx_anyhit_departures``,
their counts printed); a source that sums them on the FP32 units in the
plain version's order (the form before the tensor cores) takes the f32
``mx_sphere_table`` rows and is held bit-equal. Each source is built with
the package's nvcc flags (``ops/_build.py``), its ptxas lines printed
and, with ``--out``, its ``cuobjdump -sass`` kept and each kernel's
instructions counted (all, HMMA, LDSM), and for a tensor-core source
those of a step of its sphere loop (``step_sass``, the counts
``chip_smoke.py``'s issue-rate floor reads from the package's build).

Then each mode's call on each set is timed in a CUDA graph (device time
a call, the prebuilt table and an [N] t_max, so each source runs its
kernel alone), the sources and K1 (features, the view's table and a
float t_max, as a frame calls it) or K1c (any-hit) in turns, forward then
backward, ROUNDS rounds; the median is printed with its factor against
the baseline.

Ray sets on the random-spheres headline (BASELINE config 3, 1200x800,
486 spheres): the pool's shape, the 32,768 contiguous middle-row pixels
as primary rays (sample 0) and their live second-bounce rays; and the
frame's 960,000 primary rays and their live second-bounce rays. Any-hit
takes each set with t_max at half the plain version's hit on odd lanes
and FLT_MAX else (``chip_smoke.py`` phase 3b's).
"""

from __future__ import annotations

import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine import wavefront as wf
from tpu_pathtracer_torch.experiments.common import (ab_sources,
                                                      branch_target, build,
                                                      card, first_bounce,
                                                      graph_rounds, opcode,
                                                      sass_counts,
                                                      sass_functions)
from tpu_pathtracer_torch.experiments.spheres_ab import HEADLINE, POOL
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX

ROUNDS = 5
MODES = ("features", "any_hit")
_MODE = {"features": 1, "any_hit": 2}  # csrc/spheres_mx.cu Mode


def load(lib: Path):
    """``spheres_mx_launch`` of the library (``cuda_spheres._launcher``'s
    argument types)."""
    fn = ctypes.CDLL(str(lib)).spheres_mx_launch
    p = ctypes.c_void_p
    fn.argtypes = ([ctypes.c_int] + [p] * 7
                   + [p, ctypes.c_int, p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float] + [p] * 5)
    fn.restype = ctypes.c_int
    return fn


def _sphere_loop(code, addr, hmma):
    """(the loop, its roots' branch, the slots' instructions, each slot's
    fast path) of one kernel's code (``step_sass``)."""
    first, last = addr[hmma[0]], addr[hmma[-1]]
    back = next(k for k in range(hmma[-1], len(code))
                if (branch_target(code[k][1]) or first + 1) <= first)
    head = addr.index(branch_target(code[back][1]))
    loop = code[head:back + 1]
    fork = next(k for k, (a, i) in enumerate(loop)
                if a > last and (branch_target(i) or 0) > a)
    end = branch_target(loop[fork][1])
    region = [(a, i) for a, i in loop if loop[fork][0] < a < end]
    bodies, fast = 0, []
    for k, (a, i) in enumerate(region):
        if not opcode(i).startswith("MUFU.RSQ"):
            continue
        skip = next(j for j in range(k, -1, -1)
                    if (branch_target(region[j][1]) or 0) > a)
        stop = branch_target(region[skip][1])
        body = sum(region[skip][0] < b < stop for b, _ in region)
        slow = next(j for j in range(k, len(region))
                    if (branch_target(region[j][1]) or 0) > region[j][0])
        n_slow = sum(region[slow][0] < b < branch_target(region[slow][1])
                     for b, _ in region)
        bodies += body
        fast.append(body - n_slow)
    return loop, region, bodies, fast


def step_sass(text: str) -> dict:
    """{mode: (step, root step, root slot)} of ``csrc/spheres_mx.cu``'s
    sphere loop in a ``cuobjdump -sass`` dump of its build, for the
    features and any-hit kernels (by the mangled name's template
    argument): the instructions a warp issues for a step of the loop (8
    rays x 32 spheres: its mma, loads, epilogue and loop; any-hit with
    its vote) without the roots' branch; those the branch adds where a
    pair of the step has disc > 0 (every pair slot's test and skip); and
    those a pair slot adds where it takes its roots (the IEEE sqrtf's fast
    path, the roots, the compares and the update; the mean of the 8
    slots). The loop is the innermost backward branch around the HMMAs,
    the roots' branch its first forward branch past them, and a slot the
    code its skip jumps over around one MUFU.RSQ, less the sqrtf's slow
    path (what the branch after the MUFU.RSQ jumps over)."""
    out = {}
    for name, code in sass_functions(text).items():
        m = re.search(r"spheres_mx_kernelILi(\d)E", name)
        mode = {"1": "features", "2": "any_hit"}.get(m.group(1) if m else "")
        if mode is None:
            continue
        addr = [a for a, _ in code]
        hmma = [k for k, (_, i) in enumerate(code)
                if opcode(i).startswith("HMMA")]
        if not hmma:
            raise ValueError(f"{name}: no HMMA")
        try:
            loop, region, bodies, fast = _sphere_loop(code, addr, hmma)
        except (StopIteration, ValueError) as e:
            raise ValueError(f"{name}: no sphere loop of the form "
                             "described") from e
        if len(fast) != 8:
            raise ValueError(f"{name}: {len(fast)} MUFU.RSQ in the roots' "
                             "branch, not 8")
        out[mode] = (len(loop) - len(region), len(region) - bodies,
                     sum(fast) / len(fast))
    if set(out) != set(MODES):
        raise ValueError(f"the dump holds the sphere loops of {sorted(out)}")
    return out


def ray_sets(scene, cam, cfg, view):
    """name: (origin, direction) of the four sets."""
    dev = cam.device
    plain = [(cs, "spheres_hit_feat",
              lambda *a, tab=None: cs._spheres_hit_feat_ref(*a))]
    sets = {}
    lo = (cfg.num_pixels - POOL) // 2
    for tag, pix in (("pool", torch.arange(lo, lo + POOL, device=dev)),
                     ("960,000", torch.arange(cfg.num_pixels, device=dev))):
        o, d = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
        (o2, d2, t2), _ = first_bounce(scene, view, cfg, o, d, pix, plain)
        live = t2 > 0
        sets[f"{tag} primary"] = (o, d)
        sets[f"{tag} bounce-2"] = (V3(*(c[live].contiguous() for c in o2)),
                                   V3(*(c[live].contiguous() for c in d2)))
    return sets


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = card("spheres_mx_ab")
    texts, _, out = ab_sources(
        argv, (_build.CSRC_DIR / "spheres_mx.cu").read_text())
    with ThreadPoolExecutor(len(texts)) as ex:
        built = dict(zip(texts, ex.map(
            lambda kv: build(f"spheres_mx_{kv[0]}", kv[1], out),
            texts.items())))
    fns, mma = {}, {}
    for name, (lib, ptxas) in built.items():
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
        fns[name] = load(lib)
        mma[name] = "mma.sync.aligned" in texts[name]
        if out is not None:
            dump = (out / f"spheres_mx_{name}.sass").read_text()
            for fn_name, (n_all, n_hmma, n_ldsm) in sass_counts(
                    dump).items():
                print(f"[sass] {name} {fn_name}: {n_all} instructions, "
                      f"{n_hmma} HMMA, {n_ldsm} LDSM", flush=True)
            if mma[name]:
                try:
                    steps = step_sass(dump)
                except ValueError as e:
                    steps = f"not counted ({e})"
                print(f"[sass] {name} (step, root step, root slot): "
                      f"{steps}", flush=True)

    cfg = RenderConfig(**HEADLINE)
    scene, cam = random_spheres_scene(cfg.nx, cfg.ny, device=dev)
    view = wf.make_view(scene, cfg)
    sph = (view.sph_c, view.sph_r)
    s = view.sph_r.shape[0]
    eps = cfg.epsilon
    tabs = {True: cs.mx_operands(*sph), False: cs.mx_sphere_table(*sph)}
    sets = ray_sets(scene, cam, cfg, view)
    tm, t_any, ref = {}, {}, {}
    for sname, (o, d) in sets.items():
        n = o.x.shape[0]
        tm[sname] = torch.full((n,), FLT_MAX, device=dev)
        t1, i1 = cs.spheres_hit_soa(o, d, *sph, eps, FLT_MAX)
        odd = torch.arange(n, device=dev) % 2 == 1
        t_any[sname] = torch.where((i1 >= 0) & odd, 0.5 * t1,
                                   FLT_MAX).contiguous()
        feat = cs._spheres_hit_feat_ref(o, d, *sph, view.sph_feat, eps,
                                        tm[sname], mx=True)
        occ = cs._spheres_anyhit_ref(o, d, *sph, eps, t_any[sname], mx=True)
        ref[sname] = (feat, occ)
        print(f"[set] {sname}: {n} rays, {int((feat[1] >= 0).sum())} mx "
              f"hits, any-hit {int(occ.sum())} occluded", flush=True)

    def call(name, sname, mode):
        """One launch of ``mode`` of source ``name`` on set ``sname``."""
        o, d = sets[sname]
        n = o.x.shape[0]
        f32 = torch.float32
        t_out = idx_out = f_out = occ_out = None
        if mode == "any_hit":
            occ_out = torch.empty((n,), dtype=torch.bool, device=dev)
            tmax = t_any[sname]
        else:
            t_out = torch.empty((n,), dtype=f32, device=dev)
            idx_out = torch.empty((n,), dtype=torch.int32, device=dev)
            f_out = torch.empty((view.sph_feat.shape[1], n), dtype=f32,
                                device=dev)
            tmax = tm[sname]
        ptr = lambda a: None if a is None else a.data_ptr()
        rc = fns[name](_MODE[mode], *(a.data_ptr() for a in (*o, *d)),
                       tmax.data_ptr(), tabs[mma[name]].data_ptr(), s,
                       view.sph_feat.data_ptr(), view.sph_feat.shape[1], n,
                       eps, ptr(t_out), ptr(idx_out), ptr(f_out),
                       ptr(occ_out), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name} {mode}: CUDA error {rc}")
        if mode == "any_hit":
            return occ_out
        return t_out, idx_out, tuple(f_out.unbind(0))

    def k1(sname, mode):
        o, d = sets[sname]
        if mode == "any_hit":
            return cs.spheres_anyhit_soa(o, d, *sph, eps, t_any[sname],
                                         tab=view.sph_tab)
        return cs.spheres_hit_feat(o, d, *sph, view.sph_feat, eps, FLT_MAX,
                                   tab=view.sph_tab)

    for name in fns:
        for sname, (o, d) in sets.items():
            (tp, ip, fp), op = ref[sname]
            tk, ik, fk = call(name, sname, "features")
            ok = call(name, sname, "any_hit")
            torch.cuda.synchronize()
            if mma[name]:
                near = cs.mx_nearest_departures(o, d, *sph, eps, tm[sname],
                                                (tk, ik, fk), (tp, ip, fp))
                anyh = cs.mx_anyhit_departures(o, d, *sph, eps, t_any[sname],
                                               ok, op)
                print(f"[check] {name} {sname}: within the bound; winners "
                      f"differ on {near['differ']} of {near['lanes']} lanes "
                      f"({near['by_flip']} a flip, {near['by_tie']} a near "
                      f"tie), {near['root_flips']} agreeing lanes whose "
                      f"root may flip, max |t - plain| "
                      f"{near['t_err']:.3e} (largest bound "
                      f"{near['t_bound']:.3e}); occlusion differs on "
                      f"{anyh['differ']} of {anyh['lanes']} lanes",
                      flush=True)
            else:
                same = (torch.equal(tk, tp) and torch.equal(ik, ip)
                        and torch.equal(torch.stack(fk), torch.stack(fp))
                        and torch.equal(ok, op))
                if not same:
                    raise AssertionError(f"{name} differs from the plain "
                                         f"version on {sname}")
                print(f"[check] {name} {sname}: bit-equal to the plain "
                      "version", flush=True)

    ref_name = {"features": "K1", "any_hit": "K1c"}
    order = list(fns) + ["K1"]
    cells = [(sname, mode) for sname in sets for mode in MODES]
    times = graph_rounds(
        order, cells, lambda name, cell: (k1(*cell) if name == "K1"
                                          else call(name, *cell)), ROUNDS)
    for cell in cells:
        b = times[order[0], cell]
        row = [f"{ref_name[cell[1]] if name == 'K1' else name} "
               f"{times[name, cell]:.4f} ({b / times[name, cell]:.2f}x)"
               for name in order]
        print(f"[time] {cell[0]} {cell[1]}, ms a call in a CUDA graph, "
              f"median of {ROUNDS}: " + "; ".join(row), flush=True)

if __name__ == "__main__":
    main()
