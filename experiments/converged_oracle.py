"""Converged statistical-parity gate: the device render vs the
independent NumPy oracle at HIGH spp.

The reference's own harness measures statistical equality (RMSE over
linear radiance at equal spp, main.cpp:117-126); its real golden
assets don't exist in this environment, so the closest honest
substitute is a CONVERGED comparison against the independent oracle
on the analytic scene family the reference README describes — beyond
the bench's quick 4-spp gates. Both renderers share the counter RNG,
so this also bounds accumulated numeric drift over 100 samples x
50 bounces of kernel arithmetic.

Usage: python experiments/converged_oracle.py [spp]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    from bench import _render
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.spheres import (random_spheres_scene,
                                               three_sphere_scene)
    from tpu_pathtracer.oracle import render_oracle
    from tpu_pathtracer.utils import golden

    for name, maker, depth in (("three-sphere", three_sphere_scene, 50),
                               ("random-spheres", random_spheres_scene,
                                50)):
        cfg = RenderConfig(nx=96, ny=64, ns=spp, max_depth=depth)
        scene, cam = maker(cfg.nx, cfg.ny)
        t0 = time.time()
        _, img = _render(scene, cam, cfg, spp)
        t_dev = time.time() - t0
        t0 = time.time()
        ref = render_oracle(scene, cam, cfg)
        t_cpu = time.time() - t0
        err = golden.rmse(img, ref)
        ss = golden.ssim(img, ref)
        print(f"{name} 96x64@{spp}spp depth{depth}: rmse {err:.2e} "
              f"ssim {ss:.5f}  (device {t_dev:.1f}s, oracle {t_cpu:.0f}s)",
              flush=True)


if __name__ == "__main__":
    main()
