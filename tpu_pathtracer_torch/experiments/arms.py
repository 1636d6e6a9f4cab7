"""What the decision experiments share: arms of one frame rendered and
timed in turns, their tier and kernel launches, and the BVH builder
switch.

The twelve decision experiments (``pool_probe``, ``crossover``,
``knot_tier_ab``, ``terrain_big_ab``, ``dragon_bvh4_ab``,
``width_e2e_ab``, ``width_e2e``, ``width_sweep``, ``sah_vs_median``,
``sah_vs_median_stairs``, ``zoo_table``, ``converged_oracle``) each
render one or more arms: a scene, its camera and a ``RenderConfig``.
:func:`run_arms` warms each arm, then times each ``ns``-sample render
in turns (the arms in order, then in reverse), each timed render through
``bench.render_timed`` (CUDA events on the card, the host clock
elsewhere, the host's wall time beside, the regen iterations and each
kernel's launches of that render alone), and keeps each arm's best. On
the CPU the wrappers run their plain versions and no launch is counted.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, NamedTuple, Tuple

import numpy as np

from tpu_pathtracer_torch import bench, native
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.regen import render_regen


class Arm(NamedTuple):
    name: str
    scene: object
    cam: object
    cfg: RenderConfig


class Reading(NamedTuple):
    """An arm's timed renders."""
    name: str
    cfg: RenderConfig
    tier: str             # bench.tier: the intersection route it took
    seconds: float        # the best timed render's
    times: Tuple[float, ...]  # every timed render's, in the order run
    wall: float           # the host's wall time of the best render
    spp: int
    iters: int            # regen iterations of a render (= host syncs)
    launches: dict        # bench.read_launches() of the best render
    image: np.ndarray     # [ny, nx, 3] mean radiance of the last render

    @property
    def ms_per_spp(self) -> float:
        return self.seconds / self.spp * 1e3

    @property
    def mean(self) -> float:
        """The image's mean radiance a sample."""
        return float(self.image.mean())

    def line(self) -> str:
        """The arm's readings beside the script's own print."""
        return (f"tier {self.tier}, {self.iters} regen iterations, host "
                f"wall {self.wall:.3f} s, kernel launches {self.launches}")


def run_arms(arms: Iterable[Arm], ns: int, s0: int = 0, reps: int = 1,
             warm_ns: int = 1) -> Dict[str, Reading]:
    """Each arm warmed by a ``warm_ns``-sample render from sample 0, then
    ``reps`` rounds of timed ``ns``-sample renders from sample ``s0``, in
    turns: the arms in order in even rounds and in reverse in odd ones
    (A, B, B, A, ...). Returns each arm's :class:`Reading`, by name, its
    seconds the best of its ``reps``."""
    arms = list(arms)
    for a in arms:
        render_regen(a.scene, a.cam, a.cfg, ns=warm_ns, normalize=False)
    runs = {a.name: [] for a in arms}
    for r in range(reps):
        for a in (arms if r % 2 == 0 else arms[::-1]):
            runs[a.name].append(bench.render_timed(a.scene, a.cam, a.cfg,
                                                   ns, s0=s0, warm=False))
    out = {}
    for a in arms:
        timed = runs[a.name]
        best = min(timed, key=lambda t: t.seconds)
        out[a.name] = Reading(a.name, a.cfg, bench.tier(a.scene, a.cfg),
                              best.seconds, tuple(t.seconds for t in timed),
                              best.wall, ns, best.iters, best.launches,
                              timed[-1].image)
    return out


@contextlib.contextmanager
def builder(sah: bool):
    """Scenes built inside take the native binned-SAH builder (``sah``)
    or, with the native library switched off, the NumPy median split for
    the heap and the NumPy SAH build under the BVH4 tables: the switch
    the JAX scripts make on their own package
    (``experiments/sah_vs_median.py:18-26``), since the scene factories
    take no builder argument. The native module's state comes back on
    exit, also after an exception, so a later build in the process takes
    its usual builder."""
    saved = native._TRIED, native._LIB
    native._TRIED, native._LIB = True, None
    try:
        if sah:
            native._TRIED = False
            if native.load() is None:
                raise RuntimeError("the native BVH builder failed to load")
        yield
    finally:
        native._TRIED, native._LIB = saved
