"""CLI driver — the reference's main.cpp:62–139 with real flags.

Examples:
  python main.py --scene spheres --nx 320 --ny 200 --ns 16 -o out.png
  python main.py --scene staircase --ns 64 --stats -o stairs.png
  python main.py --scene three-sphere --store-ref   # write golden .ref
  python main.py --scene three-sphere --rmse        # compare vs golden
"""

import argparse
import sys
import time


def build(args):
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models import mesh as mesh_scenes
    from tpu_pathtracer.models import spheres as sphere_scenes

    cfg = RenderConfig(nx=args.nx, ny=args.ny, ns=args.ns,
                       max_depth=args.max_depth, stats=args.stats,
                       use_bvh=not args.no_bvh, textures=not args.no_textures,
                       russian_roulette=not args.no_roulette,
                       shadow=not args.no_shadow)
    if args.scene == "spheres":
        scene, cam = sphere_scenes.random_spheres_scene(cfg.nx, cfg.ny)
    elif args.scene.startswith("zoo-"):
        from tpu_pathtracer.models.shapes import model_zoo_scene
        scene, cam = model_zoo_scene(cfg.nx, cfg.ny, args.scene[4:])
    elif args.scene.endswith(".obj"):
        from tpu_pathtracer.models.obj import load_obj_scene
        scene, cam = load_obj_scene(args.scene, cfg.nx, cfg.ny)
    elif args.scene == "three-sphere":
        scene, cam = sphere_scenes.three_sphere_scene(cfg.nx, cfg.ny)
    elif args.scene == "staircase":
        scene, cam = mesh_scenes.procedural_staircase_scene(cfg.nx, cfg.ny)
    elif args.scene == "staircase-hires":
        # asset-scale tessellation (~154k tris)
        from tpu_pathtracer.ops.bvh import MESH_LEAF_WIDTH
        scene, cam = mesh_scenes.procedural_staircase_scene(
            cfg.nx, cfg.ny, prims_per_leaf=MESH_LEAF_WIDTH, sub=20)
    elif args.scene == "knot":
        from tpu_pathtracer.models.shapes import knot_zoo_scene
        scene, cam = knot_zoo_scene(cfg.nx, cfg.ny)
    elif args.scene == "dragon":
        # dragon-class 872k-tri knot (TODO.txt:288 workload scale)
        from tpu_pathtracer.models.shapes import knot_zoo_scene
        scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, nu=1664, nv=262)
    elif args.scene == "terrain":
        # irregular mesh: fBm terrain + thin-strut lattice (~168k tris)
        from tpu_pathtracer.models.shapes import terrain_zoo_scene
        scene, cam = terrain_zoo_scene(cfg.nx, cfg.ny)
    elif args.scene == "rocks":
        # irregular dragon-scale rock pile (~845k tris, deep overlap)
        from tpu_pathtracer.models.shapes import rocks_zoo_scene
        scene, cam = rocks_zoo_scene(cfg.nx, cfg.ny)
    elif args.scene == "terrain-big":
        # dragon-scale irregular mesh (~668k tris)
        from tpu_pathtracer.models.shapes import terrain_big_zoo_scene
        scene, cam = terrain_big_zoo_scene(cfg.nx, cfg.ny)
    elif args.scene.endswith(".bvh"):
        scene, cam = mesh_scenes.load_staircase_scene(
            args.scene, args.texture_dir, cfg.nx, cfg.ny)
    else:
        raise SystemExit(f"unknown scene {args.scene!r}")
    return scene, cam, cfg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="staircase",
                   help="spheres | three-sphere | staircase | "
                        "staircase-hires | knot | dragon | rocks | "
                        "terrain | terrain-big | "
                        "zoo-{coat,diffuse,glass,sss} | path/to/file.obj | "
                        "path/to/file.bvh")
    p.add_argument("--texture-dir", default=None)
    p.add_argument("--nx", type=int, default=640)   # main.cpp:65
    p.add_argument("--ny", type=int, default=800)   # main.cpp:66
    p.add_argument("--ns", type=int, default=256)   # main.cpp:67
    p.add_argument("--max-depth", type=int, default=64)  # main.cpp:68
    p.add_argument("-o", "--output", default=None, help=".ppm or .png")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--engine", default="regen", choices=["regen", "plain"],
                   help="regen = pixel-stationary regeneration wavefront "
                        "(fast); plain = batch wavefront (stats support)")
    p.add_argument("--tiled", action="store_true",
                   help="shard image tiles across all devices")
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("--no-textures", action="store_true")
    p.add_argument("--no-roulette", action="store_true")
    p.add_argument("--no-shadow", action="store_true")
    p.add_argument("--rmse", action="store_true",
                   help="compare against f{nx}-{ny}.ref (main.cpp:108–128)")
    p.add_argument("--store-ref", action="store_true",
                   help="write f{nx}-{ny}.ref (main.cpp:130–134)")
    args = p.parse_args(argv)

    scene, cam, cfg = build(args)
    print(f"Rendering a {cfg.nx}x{cfg.ny} image with {cfg.ns} samples per "
          f"pixel and max depth {cfg.max_depth}.", file=sys.stderr)

    from tpu_pathtracer.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    t0 = time.perf_counter()
    stats = None
    if args.tiled and args.engine == "regen" and not args.stats:
        from tpu_pathtracer.parallel.tiles import render_image_tiled_regen
        img = render_image_tiled_regen(scene, cam, cfg)
    elif args.tiled:
        from tpu_pathtracer.parallel.tiles import render_image_tiled
        out = render_image_tiled(scene, cam, cfg, report_stats=args.stats)
        img, stats = out if args.stats else (out, None)
    elif args.engine == "regen" and not args.stats:
        from tpu_pathtracer.engine.regen import render_image_regen
        img = render_image_regen(scene, cam, cfg)
    else:
        from tpu_pathtracer.engine.render import render_image
        out = render_image(scene, cam, cfg, report_stats=args.stats)
        img, stats = out if args.stats else (out, None)
    print(f"took {time.perf_counter() - t0:.3f} seconds.", file=sys.stderr)

    if stats is not None:
        for k, v in (stats._asdict() if hasattr(stats, "_asdict")
                     else stats).items():
            print(f" {k:20s}: {v}", file=sys.stderr)

    if args.output:
        from tpu_pathtracer.utils import image as im
        (im.write_png if args.output.endswith(".png") else im.write_ppm)(
            args.output, img)
        print(f"wrote {args.output}", file=sys.stderr)

    ref_file = f"f{cfg.nx}-{cfg.ny}.ref"
    if args.rmse:
        from tpu_pathtracer.utils import golden
        ref = golden.load_reference(ref_file, cfg.nx, cfg.ny)
        print(f"RMSE = {golden.rmse(img, ref)}", file=sys.stderr)
        print(f"SSIM = {golden.ssim(img, ref)}", file=sys.stderr)
    if args.store_ref:
        from tpu_pathtracer.utils import golden
        golden.save_reference(ref_file, img)
        print(f"stored {ref_file}", file=sys.stderr)


if __name__ == "__main__":
    main()
