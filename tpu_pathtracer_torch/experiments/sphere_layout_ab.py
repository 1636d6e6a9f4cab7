"""A/B of the sphere layout probe's sources on the card (K25a ``sb``,
K25b ``sbf``): ``csrc/sphere_layout_probe.cu`` and its variants against
other sources, in turns with K1, on the random-spheres headline's sets.

    python -m tpu_pathtracer_torch.experiments.sphere_layout_ab \\
        [NAME=PATH ...] [NAME=K:V,K:V ...] [--out DIR]

``NAME=PATH`` adds a source with the same C entry (``parent=FILE.cu``,
say the first form, a thread a ray over every slot: commit 68d9d84's
``csrc/sphere_layout_probe.cu`` saved under a gitignored directory),
``NAME=K:V,...`` a variant of ``csrc/sphere_layout_probe.cu`` with its
``constexpr int K`` set to V (``a4=kLanes:4`` is arm A, K1's 4 lanes a
ray; the file as it stands, ``new``, is arm B, a thread a ray with a
warp-uniform slot index, as its header says). Each
source is driven through its own C entry ``sphere_layout_launch``, built
with the package's nvcc flags (``ops/_build.py``), its ptxas lines
printed and, with ``--out``, its ``cuobjdump -sass`` kept, each kernel's
instruction count printed with its reads of the constant table
(``table_reads``) and, where it has the form, its slot loop's SASS
(``slot_sass``).

Before any is timed, every source's K25a and K25b are held on every set
bit-equal to the plain versions, and to K1 (t and idx; K25b's features).
Then each (set, mode) is timed in a CUDA graph (device time a call), the
names in turns, forward then backward, ROUNDS rounds: each source's call
as the wrapper makes it (the table's copy to constant memory, then the
kernel) and K1 (features, for ``sbf``) or K1b (t and idx, for ``sb``) as
the frame calls it. The median is printed with its factor against the
first name.

Sets (``sphere_layout_probe``): the TPU file's 16,384 rays, and the
headline's (1200x800, 486 spheres) pool of 32,768 contiguous middle-row
pixels and its 960,000 primary rays, each with the live rays of its
second bounce (``frame_sets``).
"""

from __future__ import annotations

import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor

from tpu_pathtracer_torch.experiments import sphere_layout_probe as slp
from typing import Tuple

from tpu_pathtracer_torch.experiments.common import (ISSUE_RATE, ab_sources,
                                                      backward_loops,
                                                      branch_target, build,
                                                      card, fast_count,
                                                      graph_rounds, opcode,
                                                      sass_functions)
from tpu_pathtracer_torch.ops import _build

ROUNDS = 5


def _kernels(text: str):
    """(name, template arguments, code) of the sphere layout kernels in a
    ``cuobjdump -sass`` dump: ("0",) K25a or ("1",) K25b in the first
    form, ("0", "1") K25a over all slots etc. in the current one."""
    for name, code in sass_functions(text).items():
        m = re.search(r"sphere_layout_kernelI((?:Lb\dE)+)E", name)
        if m:
            yield name, tuple(re.findall(r"Lb(\d)", m.group(1))), code


def table_reads(text: str) -> dict:
    """{template arguments: (instructions, LDC, ULDC, FP32 operations
    that take a bank-3 operand)} of the sphere layout kernels in a
    ``cuobjdump -sass`` dump: how the kernel reads its ``__constant__``
    table (an LDC into a register, a ULDC into a uniform register, or the
    operand of the FP32 instruction itself)."""
    out = {}
    for _, args, code in _kernels(text):
        ops = [(opcode(i), i) for _, i in code]
        out["".join(args)] = (
            len(code), sum(o.startswith("LDC") for o, _ in ops),
            sum(o.startswith("ULDC") for o, _ in ops),
            sum(o.startswith(("FADD", "FMUL")) and "c[0x3]" in i
                for o, i in ops))
    return out


def slot_sass(text: str) -> dict:
    """{template arguments: (pair, root)} of the sphere layout kernels in
    a ``cuobjdump -sass`` dump: the instructions a lane issues for a
    (ray, slot) pair where disc <= 0, and those the roots' branch adds
    where disc > 0, without the IEEE sqrtf's slow path. The slot loop is
    the loop with the most MUFU.RSQ (one a slot of its unrolled body); a
    slot's roots are what a forward branch in it skips over one MUFU.RSQ
    (none in the first form, which takes the roots on every slot)."""
    out = {}
    for name, args, code in _kernels(text):
        ops = [opcode(i) for _, i in code]
        rsq = lambda lo, hi: sum(o.startswith("MUFU.RSQ")
                                 for o in ops[lo:hi + 1])
        loops = [s for s in backward_loops(code) if rsq(*s)]
        if not loops:
            raise ValueError(f"{name}: no slot loop")
        lo, hi = max(loops, key=lambda s: rsq(*s))
        addr = [a for a, _ in code]
        root = 0
        for k in range(lo, hi + 1):
            t = branch_target(code[k][1])
            if t is not None and t > code[k][0] and t in addr:
                end = addr.index(t)
                if end <= hi + 1 and rsq(k + 1, end - 1) == 1:
                    root += fast_count(code, (k + 1, end - 1))
        n = rsq(lo, hi)
        out["".join(args)] = ((fast_count(code, (lo, hi)) - root) / n,
                              root / n)
    return out


def issue_floor(sass: tuple, pairs: int, disc_pairs: int
                ) -> Tuple[float, int]:
    """(ms, warp instructions): the least time the card could issue a
    kernel's slot loop (``sass``: :func:`slot_sass`'s (pair, root)) for
    ``pairs`` (ray, slot) pairs, ``disc_pairs`` of them with disc > 0, at
    ``common.ISSUE_RATE``."""
    pair, root = sass
    ins = (pairs * pair + disc_pairs * root) / 32
    return ins / ISSUE_RATE * 1e3, int(ins)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = card("sphere_layout_ab")
    texts, _, out = ab_sources(
        argv, (_build.CSRC_DIR / "sphere_layout_probe.cu").read_text())
    with ThreadPoolExecutor(len(texts)) as ex:
        built = dict(zip(texts, ex.map(
            lambda kv: build(f"layout_{kv[0]}", kv[1], out), texts.items())))
    libs = {}
    for name, (lib, ptxas) in built.items():
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
        libs[name] = slp.bind(ctypes.CDLL(str(lib)))
        if out is not None:
            dump = (out / f"layout_{name}.sass").read_text()
            print(f"[sass] {name}, by the kernel's template arguments "
                  f"(FEAT[, ALL]): (instructions, LDC, ULDC, FP32 with a "
                  f"bank-3 operand) {table_reads(dump)}; the slot loop's "
                  f"(pair, root) {slot_sass(dump)}", flush=True)

    sets = {"tpu": slp.probe_inputs(dev), **slp.frame_sets(dev)}
    for sname, inp in sets.items():
        slp.check_features(inp["feat_t"])
        for name, lib in libs.items():
            slp.check(sname, inp, slp.calls(inp, lib))
        print(f"[check] {sname}: {inp['rays'].shape[1]} rays, every source "
              f"bit-equal to the plain versions and to K1", flush=True)

    fns = {}
    for sname, inp in sets.items():
        for name, lib in libs.items():
            for mode, fn in slp.calls(inp, lib).items():
                fns[name, (sname, mode)] = fn
        fns["K1", (sname, "sb")] = lambda inp=inp: slp._k1(inp, nearest=True)
        fns["K1", (sname, "sbf")] = lambda inp=inp: slp._k1(inp)
    names = list(dict.fromkeys(k for k, _ in fns))
    cells = [(s, m) for s in sets for m in ("sb", "sbf")]
    times = graph_rounds(names, cells, lambda name, cell: fns[name, cell](),
                         ROUNDS)
    for cell in cells:
        b = times[names[0], cell]
        row = [f"{'K1b' if name == 'K1' and cell[1] == 'sb' else name} "
               f"{times[name, cell]:.4f} ({b / times[name, cell]:.2f}x)"
               for name in names]
        print(f"[time] {cell[0]} {cell[1]}, ms a call in a CUDA graph, median "
              f"of {ROUNDS}: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
