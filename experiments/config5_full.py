"""BASELINE config 5 at full scale: staircase 3840x2160 @ 1000 spp,
checkpointed sample batches (CKPT_00.02), tiled over every visible
device (render_image_tiled_regen over a device mesh; one device runs
the same sample-range decomposition). Kill it at any point and rerunning
resumes bit-exactly (counter RNG).

Usage: python experiments/config5_full.py [ns] [batch] [ckpt_path]
(writes config5.ckpt and config5_4k.png in the working directory)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ns = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    path = sys.argv[3] if len(sys.argv) > 3 else "config5.ckpt"

    import jax

    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.mesh import procedural_staircase_scene
    from tpu_pathtracer.utils.checkpoint import render_with_checkpoints
    from tpu_pathtracer.utils.image import write_png

    cfg = RenderConfig(nx=3840, ny=2160, ns=ns, max_depth=64)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny)

    t0 = time.perf_counter()
    last = [t0]

    def progress(done, total):
        now = time.perf_counter()
        print(f"  {done:5d}/{total} spp  (+{now - last[0]:6.1f} s, "
              f"total {now - t0:7.1f} s)", flush=True)
        last[0] = now

    img = render_with_checkpoints(scene, cam, cfg, path, batch=batch,
                                  progress=progress, devices=jax.devices())
    el = time.perf_counter() - t0
    print(f"config5 staircase 3840x2160@{ns}spp: {el:.1f} s "
          f"({el / ns * 1e3:.0f} ms/spp) mean={img.mean():.5f}")
    write_png("config5_4k.png", img)
    print("wrote config5_4k.png")


if __name__ == "__main__":
    main()
