"""CLI driver of the port — the flags of the JAX package's ``main.py``.

Examples:
  python -m tpu_pathtracer_torch --scene spheres --nx 1200 --ny 800 \
      --ns 100 --max-depth 50 -o out.png
  python -m tpu_pathtracer_torch --scene staircase --nx 1200 --ny 800 \
      --ns 100 -o stairs.png
  python -m tpu_pathtracer_torch --scene staircase-hires --nx 1200 \
      --ny 800 --ns 100 -o hires.png
  python -m tpu_pathtracer_torch --scene three-sphere --rmse
  python -m tpu_pathtracer_torch --scene staircase --nx 64 --ny 48 \
      --ns 2 --device cpu -o small.png
  python -m tpu_pathtracer_torch --nx 64 --ny 48 --ns 2 --tiled \
      --device cpu -o tiled.png

Renders on the CUDA device (``--device``, default ``cuda``). Without a
CUDA device it exits non-zero unless ``--device cpu`` asks for the CPU.
"""

import argparse
import sys
import time


# the large-mesh scenes of main.py: (models.shapes function, arguments)
_SHAPE_SCENES = {
    "knot": ("knot_zoo_scene", {}),
    # dragon-class 872k-triangle knot
    "dragon": ("knot_zoo_scene", dict(nu=1664, nv=262)),
    # irregular: fBm terrain + thin struts (~168k triangles)
    "terrain": ("terrain_zoo_scene", {}),
    # irregular dragon-scale rock pile (~845k triangles)
    "rocks": ("rocks_zoo_scene", {}),
    # dragon-scale irregular terrain (~668k triangles): the quant BVH4 tier
    "terrain-big": ("terrain_big_zoo_scene", {}),
}
_ZOO = ("coat", "diffuse", "glass", "sss")


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
    elif args.scene == "staircase-hires":
        # asset-scale tessellation (~154k triangles), the BVH4 tier
        scene, cam = mesh_scenes.procedural_staircase_scene(
            cfg.nx, cfg.ny, prims_per_leaf=64, sub=20, device=device)
    elif args.scene in _SHAPE_SCENES or args.scene.startswith("zoo-"):
        from tpu_pathtracer_torch.models import shapes
        if args.scene.startswith("zoo-"):
            scene, cam = shapes.model_zoo_scene(cfg.nx, cfg.ny,
                                                args.scene[4:],
                                                device=device)
        else:
            fn, kw = _SHAPE_SCENES[args.scene]
            scene, cam = getattr(shapes, fn)(cfg.nx, cfg.ny, device=device,
                                             **kw)
    elif args.scene.endswith(".obj"):
        from tpu_pathtracer_torch.models.obj import load_obj_scene
        scene, cam = load_obj_scene(args.scene, cfg.nx, cfg.ny,
                                    device=device)
    elif args.scene.endswith(".bvh"):
        scene, cam = mesh_scenes.load_staircase_scene(
            args.scene, args.texture_dir, cfg.nx, cfg.ny, device=device)
    else:
        raise SystemExit(f"unknown scene {args.scene!r}")
    return scene, cam, cfg


def make_parser() -> argparse.ArgumentParser:
    """The CLI's flags, with ``main.py``'s defaults (``main.py:71-81``)
    and ``--device``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="staircase",
                   help="spheres | three-sphere | staircase | "
                        "staircase-hires | knot | dragon | rocks | "
                        "terrain | terrain-big | "
                        "zoo-{coat,diffuse,glass,sss} | path/to/file.obj | "
                        "path/to/file.bvh")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the run fails without a CUDA "
                        "device) or cpu")
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
                   help="render image stripes over every CUDA device "
                        "(with --device cpu, over the CPU)")
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("--no-textures", action="store_true")
    p.add_argument("--no-roulette", action="store_true")
    p.add_argument("--no-shadow", action="store_true")
    p.add_argument("--rmse", action="store_true",
                   help="compare against f{nx}-{ny}.ref")
    p.add_argument("--store-ref", action="store_true",
                   help="write f{nx}-{ny}.ref")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)

    if args.scene.startswith("zoo-") and args.scene[4:] not in _ZOO:
        raise SystemExit(f"unknown scene {args.scene!r}")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "False): pass --device cpu to render on the CPU")
    scene, cam, cfg = build(args, device)
    print(f"Rendering a {cfg.nx}x{cfg.ny} image with {cfg.ns} samples per "
          f"pixel and max depth {cfg.max_depth} on {device}.",
          file=sys.stderr)

    t0 = time.perf_counter()
    stats = None
    if args.tiled and args.engine == "regen" and not args.stats:
        from tpu_pathtracer_torch.parallel.tiles import \
            render_image_tiled_regen
        img = render_image_tiled_regen(scene, cam, cfg)
    elif args.tiled:
        from tpu_pathtracer_torch.parallel.tiles import render_image_tiled
        out = render_image_tiled(scene, cam, cfg, report_stats=args.stats)
        img, stats = out if args.stats else (out, None)
    elif args.engine == "regen" and not args.stats:
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
