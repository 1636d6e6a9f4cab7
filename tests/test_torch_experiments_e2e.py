"""The port's decision experiments (``tpu_pathtracer_torch/experiments/``
``pool_probe``, ``crossover``, ``knot_tier_ab``, ``terrain_big_ab``,
``dragon_bvh4_ab``, ``width_e2e_ab``, ``width_e2e``, ``width_sweep``,
``sah_vs_median``, ``sah_vs_median_stairs``, ``zoo_table``,
``converged_oracle``) against the root ``experiments/`` scripts: each
module's defaults and arms equal its script's, read from the script's
source with ``ast`` (four of the scripts run at import); the builder
switch restores the native module, also after an exception; and the
modules on the knot, run on the CPU at 16x12: each arm's tier equals
the JAX package's dispatch for the same JAX-built scene and config
(its TPU path, ``force_feat_kernels``), the arms that compute one
function agree, and one arm of each equals the JAX package's
``_render_regen_jit`` of the same scene and samples. The modules on the
other scenes are in ``tests/test_torch_experiments_scenes.py``.

Bounds. Arms whose render runs the same kernels on the same rays
(packet widths, ``mx_leaf`` on the BVH4 tier) are bit-equal. Arms at
other lane pools run the same rays in other lanes: within 1e-6 relative
(ROADMAP C-9: the CPU's transcendentals move with a lane's SIMD
position). Arms on other tiers or builders, and each arm against the
JAX render, within rmse 1e-5 (``tests/test_bvh4.py:329``, as
``tests/test_torch_packet.py`` holds the port's mesh renders): they
differ at exact ties and by XLA's contracted multiply-adds. The JAX
reference leaves the lane pool and the TPU's packet knobs at their
defaults; they schedule rays and change no pixel.
"""

import ast
import dataclasses
import functools
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.engine import wavefront as jwf
from tpu_pathtracer.engine.regen import _render_regen_jit
from tpu_pathtracer.models import shapes as jshapes
from tpu_pathtracer.ops import bvh4 as jb4
from tpu_pathtracer_torch import native
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.experiments import (converged_oracle, crossover,
                                              dragon_bvh4_ab, knot_tier_ab,
                                              pool_probe, sah_vs_median,
                                              sah_vs_median_stairs,
                                              terrain_big_ab, width_e2e,
                                              width_e2e_ab, width_sweep,
                                              zoo_table)
from tpu_pathtracer_torch.experiments.arms import builder
from tpu_pathtracer_torch.models.shapes import knot_zoo_scene
from tpu_pathtracer_torch.ops.bvh import build_bvh
from tpu_pathtracer_torch.utils.golden import rmse
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER_RMSE = 1e-5  # tests/test_bvh4.py:329
POOL_RTOL = 1e-6    # ROADMAP C-9
TINY = dict(nx=16, ny=12, max_depth=4)
# 8,448 triangles: the packet path, with f32 BVH4 tables at 64 and 32
# triangles a leaf, in both packages
KNOT = dict(nu=176, nv=24)


# ---------------------------------------------------------------------------
# the JAX scripts' defaults, read with ast
# ---------------------------------------------------------------------------

def _tree(name):
    with open(os.path.join(ROOT, "experiments", f"{name}.py")) as f:
        return ast.parse(f.read())


def _name(func):
    return func.id if isinstance(func, ast.Name) else getattr(func, "attr",
                                                              None)


def _calls(tree, name):
    return [n for n in ast.walk(tree)
            if isinstance(n, ast.Call) and _name(n.func) == name]


def _literals(call, drop=()):
    """A call's keyword arguments that are literals, but ``drop``'s."""
    out = {}
    for k in call.keywords:
        if k.arg in drop:
            continue
        try:
            out[k.arg] = ast.literal_eval(k.value)
        except ValueError:
            pass
    return out


def _argv_defaults(tree):
    """The literal defaults of ``x if <argv test> else default``."""
    return [ast.literal_eval(n.orelse) for n in ast.walk(tree)
            if isinstance(n, ast.IfExp) and "arg" in ast.unparse(n.test)
            and isinstance(n.orelse, ast.Constant)]


def _for_iter(tree, target):
    """The literal iterable of ``for <target> in <literal>``."""
    for n in ast.walk(tree):
        if isinstance(n, ast.For) and ast.unparse(n.target) == target:
            return n.iter
    raise AssertionError(f"no loop over {target}")


def _ranges(tree):
    return [ast.literal_eval(c.args[0]) for c in _calls(tree, "range")]


def _uint32_pairs(tree):
    """(ns, s0) of each ``_render_regen_jit`` call with literal counts."""
    out = []
    for c in _calls(tree, "_render_regen_jit"):
        vals = [ast.unparse(a.args[0]) for a in c.args[3:5]]
        out.append(tuple(int(v) if v.isdigit() else v for v in vals))
    return out


def test_pool_probe_defaults():
    t = _tree("pool_probe")
    assert ast.literal_eval(_for_iter(t, "pool")) == pool_probe.POOLS
    (cfg,) = _calls(t, "RenderConfig")
    assert _literals(cfg) == pool_probe.CONFIG
    (scene,) = _calls(t, "knot_zoo_scene")
    assert [ast.literal_eval(a) for a in scene.args] == [512, 512]
    kw = [n.value for n in ast.walk(t) if isinstance(n, ast.Assign)
          and ast.unparse(n.targets[0]) == "kw"][0]
    assert ast.literal_eval(kw.body) == pool_probe.DRAGON
    assert _uint32_pairs(t) == [(1, 0), (pool_probe.SPP, pool_probe.S0)]


def test_crossover_defaults():
    t = _tree("crossover")
    assert _argv_defaults(t) == [crossover.SPP]
    (scene,) = _calls(t, "model_zoo_scene")
    assert _literals(scene) == crossover.SCENE
    (cfg,) = _calls(t, "RenderConfig")
    assert _literals(cfg, drop=("packet_threshold",)) == crossover.CONFIG
    forced = [c for c in _calls(t, "replace")]
    thresholds = (_literals(cfg)["packet_threshold"],
                  _literals(forced[0])["packet_threshold"])
    assert thresholds == tuple(crossover.THRESHOLDS.values())


def test_knot_tier_ab_defaults():
    t = _tree("knot_tier_ab")
    (cfg,) = _calls(t, "RenderConfig")
    assert _literals(cfg) == knot_tier_ab.CONFIG
    variants = [n.value for n in ast.walk(t) if isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) == "variants"][0]
    assert tuple(ast.literal_eval(v.elts[0])
                 for v in variants.elts) == knot_tier_ab.ARMS
    assert _ranges(t) == [knot_tier_ab.REPS]
    (scene,) = _calls(t, "knot_zoo_scene")
    assert not scene.keywords


def test_terrain_big_ab_defaults():
    t = _tree("terrain_big_ab")
    assert _argv_defaults(t) == [terrain_big_ab.NS]
    (cfg,) = _calls(t, "RenderConfig")
    assert _literals(cfg) == terrain_big_ab.CONFIG
    arms = {ast.literal_eval(e.elts[0]):
            (_literals(e.elts[1]) if isinstance(e.elts[1], ast.Call) else {})
            for e in _for_iter(t, "(tag, c)").elts}
    assert arms == terrain_big_ab.ARMS
    assert list(arms) == list(terrain_big_ab.ARMS)
    assert _ranges(t) == [terrain_big_ab.REPS]


def test_dragon_bvh4_ab_defaults():
    t = _tree("dragon_bvh4_ab")
    (cfg,) = _calls(t, "RenderConfig")
    assert _literals(cfg) == dragon_bvh4_ab.CONFIG
    (scene,) = _calls(t, "knot_zoo_scene")
    assert _literals(scene) == dragon_bvh4_ab.DRAGON
    knobs = {ast.unparse(n.targets[0]): _literals(n.value)["bvh4"]
             for n in ast.walk(t) if isinstance(n, ast.Assign)
             and ast.unparse(n.value).startswith("cfg.replace")}
    loop = _for_iter(t, "(name, c)")
    arms = {ast.literal_eval(e.elts[0]): knobs[ast.unparse(e.elts[1])]
            for e in loop.elts}
    assert arms == dragon_bvh4_ab.ARMS
    assert _ranges(t) == [dragon_bvh4_ab.REPS]
    starts = [ast.literal_eval(c.args[1]) for c in _calls(t, "frame")]
    assert starts == [0, dragon_bvh4_ab.S0]


def test_width_e2e_ab_defaults():
    t = _tree("width_e2e_ab")
    assert _argv_defaults(t) == [width_e2e_ab.NS]
    scenes = dict(ast.literal_eval(c.args[0]) for c in _calls(t, "append"))
    assert scenes == width_e2e_ab.SCENES
    assert ast.literal_eval(_for_iter(t, "w")) == width_e2e_ab.WIDTHS
    (cfg,) = _calls(t, "RenderConfig")
    assert _literals(cfg) == width_e2e_ab.CONFIG
    assert _ranges(t) == [width_e2e_ab.REPS]


def test_width_e2e_defaults():
    t = _tree("width_e2e")
    assigned = {ast.unparse(n.targets[0]): n.value for n in ast.walk(t)
                if isinstance(n, ast.Assign)}
    assert tuple(ast.literal_eval(assigned["WIDTHS"])) == width_e2e.WIDTHS
    assert tuple(ast.literal_eval(assigned["which"].values[1])) == \
        width_e2e.DEFAULT
    runs = {}
    for c in _calls(t, "run"):
        scene = c.args[1].body
        runs[ast.literal_eval(c.args[0])] = (
            scene.func.id, _literals(scene, drop=("prims_per_leaf",)),
            [ast.literal_eval(a) for a in scene.args],
            _literals(c.args[2]), ast.literal_eval(c.args[3]))
    ours = {case.label: (case.factory.__name__, case.scene_kw,
                         [case.config["nx"], case.config["ny"]],
                         case.config, case.ns)
            for case in width_e2e.CASES.values()}
    assert runs == ours
    assert [p[1] for p in _uint32_pairs(t)] == [0, width_e2e.S0]


def test_width_sweep_defaults():
    t = _tree("width_sweep")
    assert _argv_defaults(t) == [width_sweep.SPP]
    widths = [n.values[1] for n in ast.walk(t) if isinstance(n, ast.BoolOp)
              and isinstance(n.op, ast.Or)]
    assert [tuple(ast.literal_eval(w)) for w in widths] == \
        [width_sweep.WIDTHS]
    knot, stairs = _calls(t, "RenderConfig")
    assert _literals(knot) == width_sweep.KNOT_CONFIG
    assert _literals(stairs) == width_sweep.STAIRS_CONFIG
    kw = [n.value for n in ast.walk(t) if isinstance(n, ast.Assign)
          and ast.unparse(n.targets[0]) == "kw"][0]
    assert ast.literal_eval(kw.body) == width_sweep.CASES["dragon"][2]
    (sc,) = _calls(t, "procedural_staircase_scene")
    assert _literals(sc) == width_sweep.CASES["stairs"][2]
    mx = [n.value for n in t.body if isinstance(n, ast.Assign)
          and ast.unparse(n.targets[0]) == "MX"][0]
    assert inspect.signature(width_sweep.measure).parameters["mx"].default \
        is ast.literal_eval(mx)


@pytest.mark.parametrize("name,mod", [
    ("sah_vs_median", sah_vs_median),
    ("sah_vs_median_stairs", sah_vs_median_stairs)])
def test_sah_vs_median_defaults(name, mod):
    t = _tree(name)
    assert _argv_defaults(t) == [mod.SPP]
    (cfg,) = _calls(t, "RenderConfig")
    assert _literals(cfg) == mod.CONFIG
    arms = ast.literal_eval(_for_iter(t, "(name, use_native)"))
    assert dict(arms) == sah_vs_median.ARMS
    factory = ("procedural_staircase_scene" if "stairs" in name
               else "knot_zoo_scene")
    (scene,) = _calls(t, factory)
    assert [ast.literal_eval(a) for a in scene.args] == \
        [mod.CONFIG["nx"], mod.CONFIG["ny"]]
    assert _literals(scene) == getattr(mod, "SCENE", {})


def test_zoo_table_defaults():
    t = _tree("zoo_table")
    assert _argv_defaults(t) == [zoo_table.SPP]
    assert ast.literal_eval(_for_iter(t, "mat")) == zoo_table.MATERIALS
    (cfg,) = _calls(t, "RenderConfig")
    assert _literals(cfg) == zoo_table.CONFIG
    (scene,) = _calls(t, "model_zoo_scene")
    assert _literals(scene, drop=("material",)) == zoo_table.SCENE


def test_converged_oracle_defaults():
    t = _tree("converged_oracle")
    assert _argv_defaults(t) == [converged_oracle.SPP]
    scenes = [(ast.literal_eval(e.elts[0]), e.elts[1].id,
               ast.literal_eval(e.elts[2]))
              for e in _for_iter(t, "(name, maker, depth)").elts]
    assert scenes == [(n, m.__name__, d)
                      for n, m, d in converged_oracle.SCENES]
    (cfg,) = _calls(t, "RenderConfig")
    assert _literals(cfg) == converged_oracle.SIZE


# ---------------------------------------------------------------------------
# the builder switch
# ---------------------------------------------------------------------------

def test_builder_switch_restores_native_after_an_exception():
    before = (native._TRIED, native._LIB)
    with pytest.raises(RuntimeError, match="inside"):
        with builder(sah=False):
            assert native.load() is None
            raise RuntimeError("inside")
    assert (native._TRIED, native._LIB) == before
    rng = np.random.default_rng(3)
    v0 = rng.normal(size=(300, 3)).astype(np.float32)
    v1, v2 = v0 + 0.1, v0 + np.float32([0.0, 0.1, 0.05])
    with builder(sah=False):
        median = build_bvh(v0, v1, v2, prims_per_leaf=8, device="cpu")
    assert (native._TRIED, native._LIB) == before
    forced = build_bvh(v0, v1, v2, prims_per_leaf=8, builder="median",
                       device="cpu")
    np.testing.assert_array_equal(median.v0.numpy(), forced.v0.numpy())
    if native.load() is not None:  # g++ builds it here
        with builder(sah=True):
            assert native.load() is not None
            sah = build_bvh(v0, v1, v2, prims_per_leaf=8, device="cpu")
        assert not np.array_equal(sah.v0.numpy(), median.v0.numpy())
    native._TRIED, native._LIB = before


# ---------------------------------------------------------------------------
# the knot's modules on the CPU, against the JAX package
# ---------------------------------------------------------------------------

def jax_tier(js, cfg: RenderConfig) -> str:
    """The route the JAX package's dispatch (``make_view``,
    ``_mesh_nearest``) takes on its TPU path for ``cfg``, in
    ``bench.tier``'s names."""
    jcfg = JConfig(**{**dataclasses.asdict(cfg), "force_feat_kernels": True})
    if not js.has_mesh:
        return "spheres"
    if jwf._use_packet(js, jcfg):
        if jcfg.bvh4 and js.mesh.bvh4 is not None:
            return "quant-bvh4" if js.mesh.bvh4.quant else "bvh4"
        if jcfg.mx_leaf:
            return "heap-mx"
        return "heap-rg" if jcfg.regroup else "heap"
    return "brute" if js.mesh.num_tris <= jwf.TRI_BRUTE_MAX else "heap"


def jax_image(js, jc, ns, s0, cfg):
    """The JAX package's regen render of samples [s0, s0 + ns), a sample's
    mean, [ny, nx, 3]."""
    fb = _render_regen_jit(js, jc, cfg, jnp.uint32(ns), jnp.uint32(s0),
                           normalize=False)
    return np.asarray(fb).reshape(cfg.ny, cfg.nx, 3) / ns


REF = JConfig(ns=1, textures=False, **TINY)


@functools.lru_cache(maxsize=None)
def jknot(**kw):
    return jshapes.knot_zoo_scene(TINY["nx"], TINY["ny"], **KNOT, **kw)


def knot_ref(ns, s0):
    return jax_image(*jknot(), ns, s0, REF)


@functools.lru_cache(maxsize=None)
def pools():
    return pool_probe.measure("cpu", pools=(32, 64, 128), spp=2,
                              config=dict(TINY, ns=16), **KNOT)


def test_pool_probe_tiers_and_iterations():
    r = pools()
    assert [x.tier for x in r.values()] == \
        [jax_tier(jknot()[0], x.cfg) for x in r.values()] == ["bvh4"] * 3
    iters = [x.iters for x in r.values()]
    assert iters == sorted(iters, reverse=True) and len(set(iters)) == 3
    assert all(x.spp == 2 and len(x.times) == 1 for x in r.values())


def test_pool_probe_pools_render_one_image():
    a, *rest = (x.image for x in pools().values())
    for b in rest:
        np.testing.assert_allclose(b, a, rtol=POOL_RTOL, atol=0)


def test_pool_probe_matches_jax():
    img = pools()["pool=64"].image
    assert rmse(img, knot_ref(2, pool_probe.S0)) < RENDER_RMSE


@functools.lru_cache(maxsize=None)
def knot_tiers():
    return knot_tier_ab.measure("cpu", config=dict(TINY, ns=1,
                                                   textures=False),
                                reps=2, **KNOT)


def test_knot_tier_ab_tiers_and_equal_images():
    r = knot_tiers()
    js, _ = jknot()
    heap = dataclasses.replace(js, mesh=dataclasses.replace(js.mesh,
                                                            bvh4=None))
    want = [jax_tier(s, x.cfg) for s, x in zip((js, heap, js), r.values())]
    assert [x.tier for x in r.values()] == want == ["bvh4", "heap", "bvh4"]
    assert all(len(x.times) == knot_tier_ab.REPS for x in r.values())
    base = r["bvh4"].image
    for x in r.values():
        np.testing.assert_array_equal(x.image, base)


def test_knot_tier_ab_matches_jax():
    assert rmse(knot_tiers()["heap+pf1"].image, knot_ref(1, 0)) < RENDER_RMSE


@functools.lru_cache(maxsize=None)
def dragon():
    return dragon_bvh4_ab.measure("cpu", config=dict(TINY, ns=1,
                                                     textures=False),
                                  reps=2, quant=True, **KNOT)


def test_dragon_bvh4_ab_tiers_and_arms_agree():
    res = dragon()
    js, _ = jknot()
    jq = dataclasses.replace(js, mesh=jb4.attach_bvh4(js.mesh, quant=True))
    assert [x.tier for x in res.arms.values()] == \
        [jax_tier(jq, x.cfg) for x in res.arms.values()] == \
        ["heap", "quant-bvh4"]
    assert res.tables["nodes"] == jq.mesh.bvh4.n_nodes
    assert all(len(x.times) == 2 for x in res.arms.values())
    assert rmse(res.arms["heap"].image, res.arms["bvh4q"].image) < \
        RENDER_RMSE
    assert res.max_diff == pytest.approx(float(np.abs(
        res.arms["heap"].image - res.arms["bvh4q"].image).max()))


def test_dragon_bvh4_ab_refuses_f32_tables():
    with pytest.raises(AssertionError, match="quant"):
        dragon_bvh4_ab.measure("cpu", config=dict(TINY, ns=1), reps=1,
                               quant=False, nu=48, nv=12)


def test_dragon_bvh4_ab_matches_jax():
    assert rmse(dragon().arms["heap"].image,
                knot_ref(1, dragon_bvh4_ab.S0)) < RENDER_RMSE


@functools.lru_cache(maxsize=None)
def widths_ab():
    return width_e2e_ab.measure("cpu", 1, scenes={"knot": KNOT},
                                config=dict(TINY, textures=False), reps=2)


def test_width_e2e_ab_arms_are_one_render():
    r = widths_ab()["knot"]
    assert [x.tier for x in r.values()] == \
        [jax_tier(jknot()[0], x.cfg) for x in r.values()] == ["bvh4"] * 2
    assert [x.cfg.packet_width for x in r.values()] == [64, 128]
    np.testing.assert_array_equal(r["w=64"].image, r["w=128"].image)


def test_width_e2e_ab_matches_jax():
    assert rmse(widths_ab()["knot"]["w=64"].image, knot_ref(1, 0)) < \
        RENDER_RMSE


@functools.lru_cache(maxsize=None)
def widths_rebuilt():
    case = width_e2e.Case("knot", knot_zoo_scene, KNOT,
                          dict(TINY, ns=2, rays_per_chunk=0), 1)
    return width_e2e.measure("cpu", ("knot",), cases={"knot": case})["knot"]


def test_width_e2e_tiers_follow_jax():
    r = widths_rebuilt()
    for w, (build, x) in r.items():
        js, _ = jknot(prims_per_leaf=int(w[2:]))
        assert x.tier == jax_tier(js, x.cfg) == "bvh4"
        assert build > 0 and x.cfg.packet_width == int(w[2:])
    assert rmse(r["w=32"][1].image, r["w=64"][1].image) < RENDER_RMSE


def test_width_e2e_matches_jax():
    assert rmse(widths_rebuilt()["w=64"][1].image,
                knot_ref(1, width_e2e.S0)) < RENDER_RMSE


SWEEP = {"knot": (knot_zoo_scene, dict(TINY, textures=False,
                                       rays_per_chunk=65536), KNOT),
         # a knot without BVH4 tables on the packet path: the heap
         "heap": (knot_zoo_scene, dict(TINY, textures=False,
                                       packet_threshold=1), dict(nu=48,
                                                                 nv=12))}


@functools.lru_cache(maxsize=None)
def sweep(kind, mx):
    return width_sweep.measure("cpu", kind, 1, (64, 32), mx, cases=SWEEP)


@pytest.mark.parametrize("kind,mx,tier", [("knot", True, "bvh4"),
                                          ("knot", False, "bvh4"),
                                          ("heap", True, "heap-mx"),
                                          ("heap", False, "heap")])
def test_width_sweep_tiers_follow_jax(kind, mx, tier):
    for name, x in sweep(kind, mx).items():
        w = int(name.split("=")[1])
        js, _ = jshapes.knot_zoo_scene(TINY["nx"], TINY["ny"],
                                       prims_per_leaf=w, **SWEEP[kind][2])
        assert x.tier == jax_tier(js, x.cfg) == tier
        assert x.cfg.mx_leaf is mx


def test_width_sweep_mx_leaf_leaves_the_bvh4_tier_alone():
    for a, b in zip(sweep("knot", True).values(),
                    sweep("knot", False).values()):
        np.testing.assert_array_equal(a.image, b.image)


def test_width_sweep_matches_jax():
    assert rmse(sweep("knot", False)["width=64"].image, knot_ref(1, 0)) < \
        RENDER_RMSE


@functools.lru_cache(maxsize=None)
def builders():
    return sah_vs_median.measure("cpu", 1, dict(TINY, textures=False,
                                                rays_per_chunk=65536),
                                 **KNOT)


def test_sah_vs_median_tiers_and_arms_agree():
    from tpu_pathtracer import native as jnat
    res = builders()
    saved = jnat._TRIED, jnat._LIB
    try:  # the JAX script's switch on its own package
        jnat._TRIED, jnat._LIB = True, None
        jmed, _ = jshapes.knot_zoo_scene(TINY["nx"], TINY["ny"], **KNOT)
    finally:
        jnat._TRIED, jnat._LIB = saved
    for js, x in zip((jmed, jknot()[0]), res.arms.values()):
        assert x.tier == jax_tier(js, x.cfg) == "bvh4"
    assert set(res.builds) == {"median", "sah"} and res.speedup > 0
    assert rmse(res.arms["median"].image, res.arms["sah"].image) < \
        RENDER_RMSE


def test_sah_vs_median_matches_jax():
    assert rmse(builders().arms["sah"].image, knot_ref(1, 0)) < RENDER_RMSE
