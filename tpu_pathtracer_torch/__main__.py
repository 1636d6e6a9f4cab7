"""CLI driver of the port — the flags of the JAX package's ``main.py``.

Examples:
  python -m tpu_pathtracer_torch --scene spheres --nx 1200 --ny 800 \
      --ns 100 --max-depth 50 -o out.png
  python -m tpu_pathtracer_torch --scene staircase --nx 1200 --ny 800 \
      --ns 100 -o stairs.png
  python -m tpu_pathtracer_torch --scene three-sphere --rmse

Renders on the first CUDA device if there is one, else on the CPU.
"""

import argparse
import sys
import time

# scenes of the JAX package's CLI and the slice of the port that brings
# each (ROADMAP queue A)
_LATER = {"staircase-hires": "slice 3", "knot": "slice 3",
          "dragon": "slice 3", "terrain": "slice 3", "rocks": "slice 3",
          "terrain-big": "slice 3"}


def _later_slice(scene: str) -> str:
    if scene in _LATER:
        return _LATER[scene]
    if scene.startswith("zoo-"):
        return "slice 3"
    return ""


def build(args, device):
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import mesh as mesh_scenes
    from tpu_pathtracer_torch.models import spheres as sphere_scenes

    cfg = RenderConfig(nx=args.nx, ny=args.ny, ns=args.ns,
                       max_depth=args.max_depth, stats=args.stats,
                       use_bvh=not args.no_bvh, textures=not args.no_textures,
                       russian_roulette=not args.no_roulette,
                       shadow=not args.no_shadow)
    if args.scene == "spheres":
        scene, cam = sphere_scenes.random_spheres_scene(cfg.nx, cfg.ny,
                                                        device=device)
    elif args.scene == "three-sphere":
        scene, cam = sphere_scenes.three_sphere_scene(cfg.nx, cfg.ny,
                                                      device=device)
    elif args.scene == "staircase":
        scene, cam = mesh_scenes.procedural_staircase_scene(
            cfg.nx, cfg.ny, device=device)
    elif args.scene.endswith(".obj"):
        from tpu_pathtracer_torch.models.obj import load_obj_scene
        scene, cam = load_obj_scene(args.scene, cfg.nx, cfg.ny,
                                    device=device)
    elif args.scene.endswith(".bvh"):
        scene, cam = mesh_scenes.load_staircase_scene(
            args.scene, args.texture_dir, cfg.nx, cfg.ny, device=device)
    elif _later_slice(args.scene):
        raise SystemExit(f"scene {args.scene!r} is not ported yet: "
                         f"{_later_slice(args.scene)} of the port brings it")
    else:
        raise SystemExit(f"unknown scene {args.scene!r}")
    return scene, cam, cfg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="spheres",
                   help="spheres | three-sphere | staircase | "
                        "path/to/file.obj | path/to/file.bvh (the other "
                        "scenes of main.py come with slice 3 of the port)")
    p.add_argument("--texture-dir", default=None,
                   help="the nine staircase PNGs, for a .bvh scene")
    p.add_argument("--nx", type=int, default=640)
    p.add_argument("--ny", type=int, default=800)
    p.add_argument("--ns", type=int, default=256)
    p.add_argument("--max-depth", type=int, default=64)
    p.add_argument("-o", "--output", default=None, help=".ppm or .png")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--engine", default="regen", choices=["regen", "plain"],
                   help="regen = pixel-stationary regeneration wavefront "
                        "(fast); plain = batch wavefront (stats support)")
    p.add_argument("--tiled", action="store_true",
                   help="shard image tiles across devices (slice 4)")
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("--no-textures", action="store_true")
    p.add_argument("--no-roulette", action="store_true")
    p.add_argument("--no-shadow", action="store_true")
    p.add_argument("--rmse", action="store_true",
                   help="compare against f{nx}-{ny}.ref")
    p.add_argument("--store-ref", action="store_true",
                   help="write f{nx}-{ny}.ref")
    args = p.parse_args(argv)
    if args.tiled:
        raise SystemExit("--tiled is not ported yet: slice 4 of the port "
                         "brings it")

    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    scene, cam, cfg = build(args, device)
    print(f"Rendering a {cfg.nx}x{cfg.ny} image with {cfg.ns} samples per "
          f"pixel and max depth {cfg.max_depth} on {device}.",
          file=sys.stderr)

    t0 = time.perf_counter()
    stats = None
    if args.engine == "regen" and not args.stats:
        from tpu_pathtracer_torch.engine.regen import render_image_regen
        img = render_image_regen(scene, cam, cfg)
    else:
        from tpu_pathtracer_torch.engine.render import render_image
        out = render_image(scene, cam, cfg, report_stats=args.stats)
        img, stats = out if args.stats else (out, None)
    print(f"took {time.perf_counter() - t0:.3f} seconds.", file=sys.stderr)

    if stats is not None:
        for k, v in stats._asdict().items():
            print(f" {k:20s}: {v}", file=sys.stderr)

    if args.output:
        from tpu_pathtracer_torch.utils import image as im
        (im.write_png if args.output.endswith(".png") else im.write_ppm)(
            args.output, img)
        print(f"wrote {args.output}", file=sys.stderr)

    ref_file = f"f{cfg.nx}-{cfg.ny}.ref"
    if args.rmse:
        from tpu_pathtracer_torch.utils import golden
        ref = golden.load_reference(ref_file, cfg.nx, cfg.ny)
        print(f"RMSE = {golden.rmse(img, ref)}", file=sys.stderr)
        print(f"SSIM = {golden.ssim(img, ref)}", file=sys.stderr)
    if args.store_ref:
        from tpu_pathtracer_torch.utils import golden
        golden.save_reference(ref_file, img)
        print(f"stored {ref_file}", file=sys.stderr)


if __name__ == "__main__":
    main()
