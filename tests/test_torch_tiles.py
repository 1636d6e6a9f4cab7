"""The port's image tiles (``tpu_pathtracer_torch/parallel/tiles.py``): the
tests of ``tests/test_parallel.py:19-100`` with the CPU listed several
times in place of the JAX package's 8 virtual devices, and ``--tiled``
through the CLI."""

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch import __main__ as cli
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.regen import render_image_regen
from tpu_pathtracer_torch.engine.render import render_image
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.models.spheres import three_sphere_scene
from tpu_pathtracer_torch.parallel import tiles
from tpu_pathtracer_torch.utils import checkpoint as ck
from torch_threads import one_torch_thread  # noqa: F401

EIGHT = ["cpu"] * 8


def test_tile_devices():
    cam = three_sphere_scene(8, 8, device="cpu")[1]
    assert tiles.tile_devices(camera=cam) == [torch.device("cpu")]
    assert tiles.tile_devices(EIGHT) == [torch.device("cpu")] * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no device"):
            tiles.tile_devices()


@pytest.mark.parametrize("scene", ["spheres", "mesh"])
def test_tiled_equals_single_device(scene):
    if scene == "spheres":
        cfg = RenderConfig(nx=40, ny=32, ns=2, max_depth=6)
        s, cam = three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    else:
        cfg = RenderConfig(nx=32, ny=24, ns=2, max_depth=4)
        s, cam = procedural_staircase_scene(cfg.nx, cfg.ny, device="cpu")
    np.testing.assert_array_equal(render_image(s, cam, cfg),
                                  tiles.render_image_tiled(s, cam, cfg,
                                                           devices=EIGHT))


def test_tiled_sample_batching():
    """Sample batches must partition the sample stream, not repeat it."""
    cfg = RenderConfig(nx=24, ny=16, ns=4, max_depth=4)
    s, cam = three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    whole = tiles.render_image_tiled(s, cam, cfg, devices=EIGHT)
    batched = tiles.render_image_tiled(
        s, cam, cfg.replace(samples_per_batch=1), devices=EIGHT)
    np.testing.assert_allclose(whole, batched, atol=1e-6)


def test_tiled_subset_of_devices():
    """2 stripes against 8. The same paths, but on the CPU not bit for
    bit: PyTorch's CPU transcendentals run vectorized code on full SIMD
    blocks and scalar code on the tail, so a lane's result can move by an
    ulp with its position in the tensor (ROADMAP C-9); the bound is
    ``test_chunking_invariance``'s (tests/test_torch_render.py:167)."""
    cfg = RenderConfig(nx=24, ny=16, ns=2, max_depth=4)
    s, cam = three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    np.testing.assert_allclose(
        tiles.render_image_tiled(s, cam, cfg, devices=EIGHT[:2]),
        tiles.render_image_tiled(s, cam, cfg, devices=EIGHT),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("stripes", [2, 3, 8])
def test_tiled_regen_matches_single(stripes):
    """3 stripes of 171 pixels run past the 512-pixel frame: the tail is
    dropped."""
    cfg = RenderConfig(nx=32, ny=16, ns=2, max_depth=5, rays_per_chunk=128)
    s, cam = three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    single = render_image_regen(s, cam, cfg)
    tiled = tiles.render_image_tiled_regen(s, cam, cfg,
                                           devices=["cpu"] * stripes)
    np.testing.assert_allclose(single, tiled, atol=1e-6)


def test_tiled_stats_summed():
    cfg = RenderConfig(nx=16, ny=16, ns=2, max_depth=6, stats=True)
    s, cam = three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    img, stats = tiles.render_image_tiled(s, cam, cfg, devices=EIGHT,
                                          report_stats=True)
    _, single = render_image(s, cam, cfg, report_stats=True)
    assert stats.primary == 16 * 16 * 2
    assert stats == single


def test_config5_dress_rehearsal_tiled_checkpointed_resume(tmp_path):
    """BASELINE config 5 at dryrun scale: a tiled (8 stripes) +
    checkpointed + interrupted + resumed render equals a straight
    single-device run up to fp summation order."""
    cfg = RenderConfig(nx=48, ny=24, ns=6, max_depth=5, rays_per_chunk=128)
    s, cam = three_sphere_scene(cfg.nx, cfg.ny, device="cpu")
    straight = render_image_regen(s, cam, cfg)
    p = str(tmp_path / "c5.ckpt")
    ck.render_with_checkpoints(s, cam, cfg.replace(ns=4), p, batch=2,
                               devices=EIGHT)
    img = ck.render_with_checkpoints(s, cam, cfg, p, batch=2,
                                     devices=EIGHT)
    np.testing.assert_allclose(img, straight, atol=1e-5)
    # the same batches on one device give the same sums bit for bit
    one = ck.render_with_checkpoints(s, cam, cfg, str(tmp_path / "one"),
                                     batch=2)
    np.testing.assert_array_equal(img, one)


@pytest.mark.parametrize("engine", [["--engine", "regen"],
                                    ["--engine", "plain", "--stats"]])
def test_cli_tiled(tmp_path, engine, capsys):
    """``--tiled`` renders (the stripes of the CPU, one here) the image the
    untiled CLI writes, through both routes of main.py:108-113."""
    args = ["--scene", "three-sphere", "--nx", "16", "--ny", "12", "--ns",
            "1", "--max-depth", "3", "--device", "cpu", *engine]
    cli.main([*args, "--tiled", "-o", str(tmp_path / "t.ppm")])
    cli.main([*args, "-o", str(tmp_path / "u.ppm")])
    assert (tmp_path / "t.ppm").read_bytes() == \
        (tmp_path / "u.ppm").read_bytes()
    if "--stats" in engine:
        assert "primary" in capsys.readouterr().err
