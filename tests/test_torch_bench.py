"""The port's bench (``tpu_pathtracer_torch/bench.py``) against
``bench.py``: its frame and oracle-gate tables and its JSON line's keys
equal bench.py's, read from bench.py's source with ``ast`` (importing
bench.py's functions would load JAX); its crop is bench.py's slicing;
its crop gate passes on its own golden, fails above the bound and
without a golden, and writes nothing; its rays a path equal the JAX
bench's exactly on tiny frames; and without a CUDA device the bench
exits non-zero unless ``--device cpu`` asks for the CPU."""

import ast
import io
import json
import os
import platform
import subprocess
import sys

import numpy as np
import pytest

from test_torch_render import converted
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.models import mesh as jmesh
from tpu_pathtracer.models import spheres as jspheres
from tpu_pathtracer_torch import bench
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.models.spheres import three_sphere_scene
from tpu_pathtracer_torch.utils import golden
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(ROOT, "bench.py")


def _tree():
    with open(BENCH_PY) as f:
        return ast.parse(f.read())


def _functions():
    return {n.name: n for n in _tree().body if isinstance(n, ast.FunctionDef)}


def _calls(fn, name):
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name) and n.func.id == name]


def _kwargs(call):
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords}


def _assigned(fn, target):
    """The call assigned to ``target`` ("cfg" or "scene, cam") in ``fn``."""
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and \
                ast.unparse(n.targets[0]).strip("()") == target:
            return n.value
    raise AssertionError(f"{fn.name} assigns no {target}")


def _jax_frame(fn):
    """A bench_* function's frame as bench.py writes it."""
    cfg = _assigned(fn, "cfg")
    assert ast.unparse(cfg.func) == "RenderConfig"
    scene = _assigned(fn, "scene, cam")
    args = tuple(ast.unparse(a) for a in scene.args)
    renders = [c for c in _calls(fn, "_render_batched")
               if ast.unparse(c.args[0]) == "scene"]
    gates = _calls(fn, "_gate")
    assert len(gates) == 1
    return dict(config=_kwargs(cfg), factory=scene.func.id,
                size=None if args == ("cfg.nx", "cfg.ny")
                else tuple(ast.literal_eval(a) for a in args),
                scene_kwargs=_kwargs(scene),
                spp=ast.literal_eval(renders[0].args[3]),
                more_spp=(ast.literal_eval(renders[1].args[3])
                          if len(renders) > 1 else None),
                crop=ast.literal_eval(gates[0].args[0]),
                asserts_quant=any("quant" in ast.unparse(n)
                                  for n in ast.walk(fn)
                                  if isinstance(n, ast.Assert)))


@pytest.mark.parametrize("name", sorted(bench.FRAMES))
def test_frame_equals_bench_py(name):
    """(a) Each frame's RenderConfig, scene factory and its arguments, spp,
    second render and crop name equal bench.py's bench_<name>; sample
    batches are the one documented departure."""
    ours = bench.FRAMES[name]
    theirs = _jax_frame(_functions()[f"bench_{name}"])
    assert ours.config == theirs["config"]
    assert ours.factory.__name__ == theirs["factory"]
    assert ours.size == theirs["size"]
    assert ours.scene_kwargs == theirs["scene_kwargs"]
    assert ours.spp == theirs["spp"]
    assert (ours.more and ours.more[1]) == theirs["more_spp"]
    assert ours.crop == theirs["crop"]
    assert (ours.tier == "quant-bvh4") == theirs["asserts_quant"]


def test_frame_order_is_bench_py_main():
    """bench.py's main runs its frames (through ``_retry``) in ORDER."""
    main = _functions()["main"]
    named = sorted((n.lineno, n.col_offset, n.id) for n in ast.walk(main)
                   if isinstance(n, ast.Name) and n.id.startswith("bench_"))
    assert [n for _, _, n in named] == [f"bench_{name}"
                                        for name in bench.ORDER]
    assert set(bench.ORDER) == set(bench.FRAMES)


def _jax_gates():
    """{name: (call line, factory, scene kwargs, config, rmse, ssim)} of
    bench.py's _oracle_gate calls."""
    out = {}
    for fn in _functions().values():
        for call in _calls(fn, "_oracle_gate"):
            cfg = _assigned(fn, "gcfg")
            scene = _assigned(fn, "gscene, gcam")
            assert [ast.unparse(a) for a in scene.args] == ["gcfg.nx",
                                                            "gcfg.ny"]
            kw = _kwargs(call)
            out[ast.literal_eval(call.args[0])] = (
                call.lineno, scene.func.id, _kwargs(scene), _kwargs(cfg),
                kw["rmse_tol"], kw["ssim_min"])
    return out


def test_oracle_gates_equal_bench_py():
    """(b) The gate table equals bench.py's _oracle_gate calls: name,
    scene, shape and bounds; each gate's lines hold its call."""
    theirs = _jax_gates()
    assert sorted(theirs) == sorted(g.name for g in bench.ORACLE_GATES)
    for g in bench.ORACLE_GATES:
        line, factory, kw, cfg, tol, smin = theirs[g.name]
        lo, hi = map(int, g.where.split(":")[1].split("-"))
        assert lo <= line <= hi
        assert (g.factory.__name__, g.scene_kwargs, g.config) == \
            (factory, kw, cfg)
        assert (g.rmse_tol, g.ssim_min) == (tol, smin)


def _jax_line_keys():
    """The top-level and ``extra`` keys bench.py's main writes."""
    main = _functions()["main"]
    extra = set()
    for n in ast.walk(main):
        if isinstance(n, ast.Assign):
            t = n.targets[0]
            if isinstance(t, ast.Name) and t.id == "extra":
                extra |= {ast.literal_eval(k) for k in n.value.keys}
            elif isinstance(t, ast.Subscript) and \
                    ast.unparse(t.value) == "extra":
                extra.add(ast.literal_eval(t.slice))
    dumps = [c for c in ast.walk(main) if isinstance(c, ast.Call)
             and ast.unparse(c.func) == "json.dumps"]
    assert len(dumps) == 1
    top = {ast.literal_eval(k) for k in dumps[0].args[0].keys}
    return top, extra


RESULTS = {"headline": 61.2345678, "config2": 7.7777777,
           "rays_per_path": 2.5123, "staircase": 101.55555,
           "knot": 0.812345, "dragon": 0.31234, "terrain": 0.61234,
           "terrain_big": 0.41234, "rocks": 0.51234,
           "staircase_hires": 0.81234, "config4": 30.12345,
           "device": "NVIDIA H100 80GB HBM3, 700.00 W"}


def test_line_keys_equal_bench_py_plus_device():
    """(c) bench_line's keys are bench.py's, plus extra.device; values
    rounded as bench.py:395-402 rounds them."""
    top, extra = _jax_line_keys()
    line = bench.bench_line(RESULTS)
    assert set(line) == top
    assert set(line["extra"]) == extra | {"device"}
    assert line["metric"] == "random_spheres_1200x800_100spp_wall_clock"
    assert line["value"] == round(RESULTS["headline"], 4)
    assert line["vs_baseline"] == round(6.48 / RESULTS["headline"], 3)
    assert line["mrays_per_sec"] == round(
        1200 * 800 * 100 * RESULTS["rays_per_path"] / RESULTS["headline"]
        / 1e6, 2)
    ex = line["extra"]
    assert ex["config2_vs_baseline"] == round(2.1 / RESULTS["config2"], 3)
    assert ex["dragon_872k_ms_per_spp"] == round(
        RESULTS["dragon"] / 4 * 1e3, 1)
    assert ex["terrain_168k_ms_per_spp"] == round(
        RESULTS["terrain"] / 8 * 1e3, 1)
    assert ex["zoo_knot_102k_512_16spp_s"] == round(RESULTS["knot"], 4)
    assert ex["staircase_hires_154k_s_per_spp"] == round(
        RESULTS["staircase_hires"] / 2, 4)
    assert ex["config4_staircase_100spp_s"] == round(RESULTS["config4"], 2)
    assert ex["config4_basis"] == "measured"
    assert ex["device"] == RESULTS["device"]


def _jax_crop():
    """bench.py's crop expression (in ``_gate``), compiled."""
    for n in ast.walk(_functions()["_gate"]):
        if isinstance(n, ast.Assign) and ast.unparse(n.targets[0]) == "crop":
            return compile(ast.Expression(n.value), BENCH_PY, "eval")
    raise AssertionError("bench.py's _gate takes no crop")


@pytest.mark.parametrize("shape", [(800, 1200), (512, 512), (48, 64)])
def test_crop_equals_bench_py(shape):
    """(d) The crop is bench.py's slicing, also under 128 pixels."""
    img = np.random.default_rng(7).random((*shape, 3), dtype=np.float32)
    ny, nx = shape
    theirs = eval(_jax_crop(), {"np": np, "max": max},
                  {"img": img, "cy": ny // 2, "cx": nx // 2})
    ours = bench.center_crop(img)
    assert ours.dtype == np.float32 and ours.flags.c_contiguous
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (min(ny, 128), min(nx, 128), 3)


def test_gate_passes_on_its_golden_and_fails_above(tmp_path):
    """(e) The crop gate on its own golden: rmse 0 passes; an image off
    by more than the bound raises; a missing golden raises and writes
    nothing."""
    img = np.random.default_rng(3).random((200, 300, 3), dtype=np.float32)
    golden.save_reference(str(tmp_path / "bench_t.ref"),
                          bench.center_crop(img))
    assert bench.gate("t", img, str(tmp_path)) == (0.0, pytest.approx(1.0))
    near = img + np.float32(1e-3)
    r, s = bench.gate("t", near, str(tmp_path))
    assert 0 < r < bench.RMSE_TOL and s >= bench.SSIM_MIN
    with pytest.raises(bench.ImageGateError, match="FAILED"):
        bench.gate("t", img + np.float32(6e-3), str(tmp_path))
    with pytest.raises(bench.ImageGateError, match="non-finite"):
        bench.gate("t", np.where(img > 0.5, np.nan, img), str(tmp_path))
    before = sorted(os.listdir(tmp_path))
    with pytest.raises(bench.ImageGateError, match="no golden"):
        bench.gate("missing", img, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == before


def test_every_frame_has_its_committed_golden():
    for f in bench.FRAMES.values():
        ref = golden.load_reference(os.path.join(bench.GOLDEN_DIR,
                                                 f"bench_{f.crop}.ref"))
        assert ref.shape == (128, 128, 3) and np.isfinite(ref).all()


def test_oracle_gate_check_bounds():
    """The oracle gate holds the render at the gate's bounds."""
    g = bench.ORACLE_GATES[-1]
    ref = np.random.default_rng(5).random((64, 96, 3), dtype=np.float32)
    r, s = bench.check_oracle_gate(g, ref + np.float32(1e-3), ref)
    assert r < g.rmse_tol and s >= g.ssim_min
    with pytest.raises(bench.ImageGateError, match="FAILED"):
        bench.check_oracle_gate(g, ref + np.float32(2 * g.rmse_tol),
                                ref)
    with pytest.raises(bench.ImageGateError):
        bench.check_oracle_gate(g, ref[:32], ref)


def test_run_frame_on_the_cpu(tmp_path):
    """A tiny frame through run_frame and render_timed on the CPU: timed
    by the host clock, its regen iterations counted, no kernel launched,
    gated against a golden of the same render."""
    frame = bench.Frame("t", "three-sphere 32x24@2spp", three_sphere_scene,
                        None, {}, dict(nx=32, ny=24, ns=2, max_depth=4), 2,
                        "t")
    cfg = RenderConfig(**frame.config)
    scene, cam = three_sphere_scene(32, 24, device="cpu")
    first = bench.render_timed(scene, cam, cfg)
    golden.save_reference(str(tmp_path / "bench_t.ref"),
                          bench.center_crop(first.image))
    built = bench.build_frame(frame, "cpu")
    assert built.cfg == cfg
    run = bench.run_frame(frame, built, golden_dir=str(tmp_path))
    assert run.tier == "spheres" and run.timed.launches == {}
    assert run.timed.iters > 0 and run.timed.seconds > 0
    assert run.rmse == 0.0
    np.testing.assert_array_equal(run.timed.image, first.image)
    # a knob changed renders in place of the frame's own config
    knob = bench.run_frame(frame, built, cfg.replace(fast_math=True),
                           golden_dir=str(tmp_path))
    assert knob.cfg.fast_math and knob.rmse < bench.RMSE_TOL


SMALL = dict(nx=96, ny=64, ns=4, max_depth=8)


@pytest.mark.parametrize("name,factory", [
    ("spheres", jspheres.random_spheres_scene),
    ("staircase", jmesh.procedural_staircase_scene)])
def test_rays_per_path_equals_jax_bench(name, factory):
    """(f) The stats pass (96x64 -> 24x16, 4 spp, depth 8) gives the JAX
    bench's rays a path exactly, on the JAX scene carried across."""
    import bench as jbench

    js, jc = factory(SMALL["nx"], SMALL["ny"])
    theirs = jbench._rays_per_path(js, jc, JConfig(**SMALL))
    ours = bench.rays_per_path(bench.path_stats(*converted(js, jc),
                                                RenderConfig(**SMALL))[1])
    assert ours == theirs and ours > 1.0


def test_cpu_model_without_a_reported_name(monkeypatch):
    """A host whose /proc/cpuinfo and lscpu report no model name (or
    "unknown") still gets a line: its architecture from ``platform``."""
    real_open = open

    def fake_open(path, *a, **k):
        if path == "/proc/cpuinfo":
            return io.StringIO("processor\t: 0\nmodel name\t: unknown\n")
        return real_open(path, *a, **k)

    monkeypatch.setattr("builtins.open", fake_open)
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, "Model name: \n",
                                                    ""))
    name = bench.cpu_model()
    assert isinstance(name, str) and "unknown" not in name
    assert name.startswith(platform.machine())
    assert name.endswith("(model not reported)")


@pytest.mark.parametrize("oracles", ["beside", "after"])
def test_main_on_the_cpu(monkeypatch, capsys, oracles):
    """main with --device cpu in either oracle order, on tiny frames (the
    three-sphere scene at 32x24, 2 spp) and the spheres gate at 32x24: the
    frames in ORDER, each with its count of oracle processes beside it
    (none when they start after the last frame), the gate checked, and
    the JSON line last on stdout."""
    frames = {k: f._replace(factory=three_sphere_scene, size=None,
                            scene_kwargs={}, tier=None, spp=2,
                            config=dict(nx=32, ny=24, ns=2, max_depth=4),
                            more=f.more and (f.more[0], 2))
              for k, f in bench.FRAMES.items()}
    spheres = bench.ORACLE_GATES[-1]
    monkeypatch.setattr(bench, "FRAMES", frames)
    monkeypatch.setattr(bench, "ORACLE_GATES", (spheres._replace(
        config={**spheres.config, "nx": 32, "ny": 24}),))
    monkeypatch.setattr(bench, "gate", lambda name, img, where: (0.0, 1.0))
    bench.main(["--device", "cpu", "--oracles", oracles])
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["extra"]["device"] == "cpu" and line["value"] > 0
    beside = [ln.split(":")[0].strip() for ln in err.splitlines()
              if "running oracle processes" in ln]
    assert beside == list(bench.ORDER)
    if oracles == "after":
        assert "beside 0 running oracle processes at its start, 0" in err
    assert "oracle gate spheres" in err and "OK" in err


def test_bench_exits_without_a_card():
    """(g) No CUDA device and no --device cpu: a non-zero exit, no line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join(filter(None, [
               ROOT, os.environ.get("PYTHONPATH")]))}
    out = subprocess.run([sys.executable, "-m", "tpu_pathtracer_torch.bench"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
