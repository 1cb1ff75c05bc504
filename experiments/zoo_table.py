"""Model-zoo material table (TODO.txt:293-298 recipe) on the device.

One compiled executable serves all four materials (same shapes).

Usage: python experiments/zoo_table.py [spp]
"""

import sys
import time

import jax.numpy as jnp
import numpy as np


def main():
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.engine.regen import _render_regen_jit
    from tpu_pathtracer.models.shapes import model_zoo_scene

    cfg = RenderConfig(nx=512, ny=512, ns=spp, max_depth=50,
                       textures=False)
    for mat in ("coat", "diffuse", "glass", "sss"):
        scene, cam = model_zoo_scene(512, 512, material=mat, nu=96, nv=64)
        np.asarray(_render_regen_jit(scene, cam, cfg, jnp.uint32(1),
                                     jnp.uint32(0), normalize=False)[0])
        t0 = time.perf_counter()
        fb, _ = _render_regen_jit(scene, cam, cfg, jnp.uint32(spp),
                                  jnp.uint32(0), normalize=False)
        fb.block_until_ready()
        a = np.asarray(fb)
        el = time.perf_counter() - t0
        print(f"zoo-{mat:7s} 512x512@{spp}spp: {el:7.2f} s "
              f"mean={a.mean()/spp:.5f}", flush=True)


if __name__ == "__main__":
    main()
