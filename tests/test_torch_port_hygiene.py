"""The port stands alone: every module imports with JAX made unimportable
and never loads the JAX package, and its RenderConfig carries the JAX
package's knobs unchanged."""

import dataclasses
import os
import pkgutil
import subprocess
import sys
import warnings

import pytest

import tpu_pathtracer_torch
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer_torch.config import RenderConfig
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = {**os.environ, "PYTHONPATH": os.pathsep.join(
    filter(None, [ROOT, os.environ.get("PYTHONPATH")]))}


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        tpu_pathtracer_torch.__path__, "tpu_pathtracer_torch."))


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert {"tpu_pathtracer_torch.ops.cuda_spheres",
            "tpu_pathtracer_torch.ops.cuda_tris",
            "tpu_pathtracer_torch.ops.cuda_bvh",
            "tpu_pathtracer_torch.ops.cuda_bvh4",
            "tpu_pathtracer_torch.ops.cuda_bvh_mx",
            "tpu_pathtracer_torch.ops.cuda_bvh_rg",
            "tpu_pathtracer_torch.ops.cuda_bvh_mr",
            "tpu_pathtracer_torch.experiments.phase_probe",
            "tpu_pathtracer_torch.experiments.iter_ablate",
            "tpu_pathtracer_torch.experiments.leafmt_probe",
            "tpu_pathtracer_torch.experiments.dma_probe",
            "tpu_pathtracer_torch.experiments.dual_probe",
            "tpu_pathtracer_torch.experiments.tpu_micro",
            "tpu_pathtracer_torch.experiments.regroup_probe",
            "tpu_pathtracer_torch.experiments.leafround_probe",
            "tpu_pathtracer_torch.experiments.multirow_probe",
            "tpu_pathtracer_torch.experiments.gather_probe",
            "tpu_pathtracer_torch.experiments.sphere_layout_probe",
            "tpu_pathtracer_torch.experiments.shapecast_probe",
            "tpu_pathtracer_torch.experiments.bvh4_ab",
            "tpu_pathtracer_torch.experiments.spheres_ab",
            "tpu_pathtracer_torch.experiments.spheres_mx_ab",
            "tpu_pathtracer_torch.experiments.bvh_mx_ab",
            "tpu_pathtracer_torch.experiments.bvh_ab",
            "tpu_pathtracer_torch.experiments.bvh_rg_ab",
            "tpu_pathtracer_torch.experiments.bvh_mr_ab",
            "tpu_pathtracer_torch.ops.bvh4",
            "tpu_pathtracer_torch.models.shapes",
            "tpu_pathtracer_torch.models.presets",
            "tpu_pathtracer_torch.native",
            "tpu_pathtracer_torch.oracle",
            "tpu_pathtracer_torch.utils.checkpoint",
            "tpu_pathtracer_torch.utils.profiling",
            "tpu_pathtracer_torch.parallel.tiles",
            "tpu_pathtracer_torch.experiments.config5_full",
            "tpu_pathtracer_torch.experiments.oracle_contention",
            "tpu_pathtracer_torch.experiments.arms",
            "tpu_pathtracer_torch.experiments.pool_probe",
            "tpu_pathtracer_torch.experiments.crossover",
            "tpu_pathtracer_torch.experiments.knot_tier_ab",
            "tpu_pathtracer_torch.experiments.terrain_big_ab",
            "tpu_pathtracer_torch.experiments.dragon_bvh4_ab",
            "tpu_pathtracer_torch.experiments.width_e2e_ab",
            "tpu_pathtracer_torch.experiments.width_e2e",
            "tpu_pathtracer_torch.experiments.width_sweep",
            "tpu_pathtracer_torch.experiments.sah_vs_median",
            "tpu_pathtracer_torch.experiments.sah_vs_median_stairs",
            "tpu_pathtracer_torch.experiments.zoo_table",
            "tpu_pathtracer_torch.experiments.converged_oracle",
            "tpu_pathtracer_torch.bench"} <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]\n"
        "       or m.split('.')[0] == 'tpu_pathtracer']\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env=_ENV)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith("ok")


def test_import_builds_nothing():
    code = ("import tpu_pathtracer_torch.engine.regen, "
            "tpu_pathtracer_torch.__main__, "
            "tpu_pathtracer_torch.models.mesh, "
            "tpu_pathtracer_torch.models.obj, "
            "tpu_pathtracer_torch.models.shapes, "
            "tpu_pathtracer_torch.ops.cuda_bvh4, "
            "tpu_pathtracer_torch.ops.cuda_bvh_mx, "
            "tpu_pathtracer_torch.ops.cuda_bvh_rg, "
            "tpu_pathtracer_torch.ops.cuda_bvh_mr, "
            "tpu_pathtracer_torch.experiments.phase_probe, "
            "tpu_pathtracer_torch.experiments.iter_ablate, "
            "tpu_pathtracer_torch.experiments.leafmt_probe, "
            "tpu_pathtracer_torch.experiments.dma_probe, "
            "tpu_pathtracer_torch.experiments.dual_probe, "
            "tpu_pathtracer_torch.experiments.tpu_micro, "
            "tpu_pathtracer_torch.experiments.regroup_probe, "
            "tpu_pathtracer_torch.experiments.leafround_probe, "
            "tpu_pathtracer_torch.experiments.multirow_probe, "
            "tpu_pathtracer_torch.experiments.gather_probe, "
            "tpu_pathtracer_torch.experiments.sphere_layout_probe, "
            "tpu_pathtracer_torch.experiments.shapecast_probe, "
            "tpu_pathtracer_torch.experiments.bvh4_ab, "
            "tpu_pathtracer_torch.experiments.spheres_ab, "
            "tpu_pathtracer_torch.experiments.spheres_mx_ab, "
            "tpu_pathtracer_torch.experiments.bvh_mx_ab, "
            "tpu_pathtracer_torch.experiments.bvh_ab, "
            "tpu_pathtracer_torch.experiments.bvh_rg_ab, "
            "tpu_pathtracer_torch.experiments.config5_full, "
            "tpu_pathtracer_torch.experiments.oracle_contention, "
            "tpu_pathtracer_torch.experiments.arms, "
            "tpu_pathtracer_torch.experiments.pool_probe, "
            "tpu_pathtracer_torch.experiments.crossover, "
            "tpu_pathtracer_torch.experiments.knot_tier_ab, "
            "tpu_pathtracer_torch.experiments.terrain_big_ab, "
            "tpu_pathtracer_torch.experiments.dragon_bvh4_ab, "
            "tpu_pathtracer_torch.experiments.width_e2e_ab, "
            "tpu_pathtracer_torch.experiments.width_e2e, "
            "tpu_pathtracer_torch.experiments.width_sweep, "
            "tpu_pathtracer_torch.experiments.sah_vs_median, "
            "tpu_pathtracer_torch.experiments.sah_vs_median_stairs, "
            "tpu_pathtracer_torch.experiments.zoo_table, "
            "tpu_pathtracer_torch.experiments.converged_oracle, "
            "tpu_pathtracer_torch.oracle, "
            "tpu_pathtracer_torch.utils.checkpoint, "
            "tpu_pathtracer_torch.utils.profiling, "
            "tpu_pathtracer_torch.parallel.tiles\n"
            "from tpu_pathtracer_torch import native\n"
            "from tpu_pathtracer_torch.ops import _build\n"
            "assert _build._LOADED == {}\n"
            "assert not native._TRIED and native._LIB is None\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env=_ENV)
    assert p.returncode == 0, p.stderr


@pytest.mark.parametrize("probe", ["phase_probe", "iter_ablate",
                                   "leafmt_probe", "dma_probe",
                                   "dual_probe", "tpu_micro",
                                   "regroup_probe", "leafround_probe",
                                   "multirow_probe", "gather_probe",
                                   "sphere_layout_probe",
                                   "sphere_layout_ab",
                                   "shapecast_probe", "spheres_mx_ab",
                                   "bvh_mx_ab",
                                   "bvh_ab", "bvh_rg_ab",
                                   "config5_full", "oracle_contention",
                                   "pool_probe", "crossover",
                                   "knot_tier_ab", "terrain_big_ab",
                                   "dragon_bvh4_ab", "width_e2e_ab",
                                   "width_e2e", "width_sweep",
                                   "sah_vs_median", "sah_vs_median_stairs",
                                   "zoo_table", "converged_oracle"])
def test_probes_exit_without_a_card(probe):
    """A probe measures the card and has no CPU mode: without a CUDA
    device it exits non-zero and prints nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe would run")
    p = subprocess.run([sys.executable, "-m",
                        f"tpu_pathtracer_torch.experiments.{probe}"],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT, env=_ENV)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(RenderConfig)]
    assert tf == jf


@pytest.mark.parametrize("kw", [dict(packet_split=True),
                                dict(oct=True, prefetch=True),
                                dict(check_nans=True),
                                dict(packet_width=48),
                                dict(mx_leaf=True, regroup=True)])
def test_validate_warns_like_jax(kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert len(RenderConfig(**kw).validate()) == len(
            JConfig(**kw).validate()) > 0


def test_flush_window_below_zero_is_rejected():
    with pytest.raises(ValueError, match="flush_window"):
        RenderConfig(flush_window=-1)
    assert RenderConfig(flush_window=4).flush_window == 4
