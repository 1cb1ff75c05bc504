"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline workload (BASELINE.md): random-spheres 1200×800 @ 100 spp,
max depth 50 — the reference's final README state ran it in 6.48 s on a
GTX 1050 (README.md:94). ``vs_baseline`` is baseline_time / our_time
(>1 = faster than the reference).

The single JSON line also carries the other BASELINE configs and the
Mrays/sec metric under ``extra``, and names the device it ran on:
  * config 2 — random-spheres 1200×800 @ 10 spp (README.md:70: 2.1 s)
  * staircase-toy — 396-tri procedural staircase 1200×800 @ 100 spp
  * config 4 — the asset-scale 154k-tri staircase (BVH + textures +
    NEE) at 1200×800 @ 100 spp
  * large-mesh zoo — 102k-tri torus knot 512×512 @ 16 spp, the 872k-tri
    dragon-class knot, the irregular terrain (168k and 668k tris) and
    the 845k-tri rock pile

The bench needs a GPU and fails without one; any failed cell makes it
exit non-zero after the others have run.
"""

import json
import os
import sys
import time

BASELINE_100SPP = 6.48   # README.md:94, GTX 1050
BASELINE_10SPP = 2.1     # README.md:70, GTX 1050
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets")
GOLDEN_RMSE = 1e-3


class ImageGateError(AssertionError):
    """Deterministic radiance mismatch vs a committed golden."""


def gate(name, img):
    """On-device image gate: compare a 128x128 center crop of the
    [ny, nx, 3] *linear mean radiance* image against a committed golden
    (reference mechanism: main.cpp:117-126). A perf change that shifts
    radiance fails the bench loudly instead of shipping a wrong image
    under a green timing. Set BENCH_STORE_REF=1 to (re)generate goldens
    after an intentional radiance change; a missing golden is an
    error."""
    import numpy as np

    from tpu_pathtracer.utils.golden import (load_reference, rmse,
                                             save_reference)
    ny, nx = img.shape[:2]
    cy, cx = ny // 2, nx // 2
    crop = np.ascontiguousarray(
        img[max(cy - 64, 0):cy + 64, max(cx - 64, 0):cx + 64],
        np.float32)
    path = os.path.join(GOLDEN_DIR, f"bench_{name}.ref")
    if os.environ.get("BENCH_STORE_REF"):
        save_reference(path, crop)
        print(f"  stored golden {path}", file=sys.stderr)
        return
    if not os.path.exists(path):
        raise ImageGateError(f"no golden {path} for {name}: store one "
                             "with BENCH_STORE_REF=1")
    err = rmse(crop, load_reference(path))
    if err >= GOLDEN_RMSE:
        raise ImageGateError(
            f"image gate FAILED for {name}: rmse {err:.2e} >= "
            f"{GOLDEN_RMSE:.0e} vs committed golden {path}")
    print(f"  image gate {name}: rmse {err:.2e} OK", file=sys.stderr)


def _oracle_gate(name, scene, cam, cfg, rmse_tol, ssim_min):
    """On-device oracle cross-check: a low-res render on the GPU must
    match the independent NumPy oracle (same RNG streams — reference
    analogue: the no-BVH slow-oracle path, kernels.cu:307–321). Unlike
    ``gate`` this re-anchors every run to an independent
    implementation, so device-only numeric drift can't be ratified into
    the stored goldens."""
    from tpu_pathtracer.oracle import render_oracle
    from tpu_pathtracer.utils import golden

    _, img = _render(scene, cam, cfg, cfg.ns)
    ref = render_oracle(scene, cam, cfg)
    err, ss = golden.rmse(img, ref), golden.ssim(img, ref)
    if err >= rmse_tol or ss < ssim_min:
        raise ImageGateError(
            f"oracle gate FAILED for {name}: rmse {err:.2e} "
            f"(tol {rmse_tol:.0e}) ssim {ss:.4f} (min {ssim_min})")
    print(f"  oracle gate {name}: rmse {err:.2e} ssim {ss:.4f} OK",
          file=sys.stderr)


def _render(scene, cam, cfg, ns):
    """Timed render of `ns` samples in one dispatch; returns (seconds,
    [ny, nx, 3] mean image). Timing matches the reference driver, which
    times runRenderer only (main.cpp:96-101). The warm-up call compiles
    the same executable (the sample count is a dynamic scalar)."""
    import jax.numpy as jnp
    import numpy as np

    from tpu_pathtracer.engine.regen import _render_regen_jit

    fb, _ = _render_regen_jit(scene, cam, cfg, jnp.uint32(1), jnp.uint32(0))
    fb.block_until_ready()
    t0 = time.perf_counter()
    fb, _ = _render_regen_jit(scene, cam, cfg, jnp.uint32(ns), jnp.uint32(0))
    fb.block_until_ready()
    elapsed = time.perf_counter() - t0
    return elapsed, np.asarray(fb).reshape(cfg.ny, cfg.nx, 3)


def _rays_per_path(scene, cam, cfg):
    """Measured rays per camera path (primary+secondary+shadow) from a
    short stats-enabled run — converts Mpaths/s to Mrays/s."""
    import jax
    import jax.numpy as jnp

    from tpu_pathtracer.engine.regen import render_regen

    scfg = cfg.replace(stats=True, nx=cfg.nx // 4, ny=cfg.ny // 4)
    _, stats = jax.jit(
        lambda s, c: render_regen(s, c, scfg, ns=jnp.uint32(4)))(scene, cam)
    rays = int(stats.primary) + int(stats.secondary) + int(stats.shadows)
    return rays / max(int(stats.primary), 1)


def bench_headline():
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.spheres import random_spheres_scene

    gcfg = RenderConfig(nx=96, ny=64, ns=4, max_depth=8)
    gscene, gcam = random_spheres_scene(gcfg.nx, gcfg.ny)
    _oracle_gate("spheres", gscene, gcam, gcfg,
                 rmse_tol=5e-3, ssim_min=0.99)

    cfg = RenderConfig(nx=1200, ny=800, ns=100, max_depth=50)
    scene, cam = random_spheres_scene(cfg.nx, cfg.ny)
    elapsed, img = _render(scene, cam, cfg, 100)
    gate("spheres_100spp", img)
    rpp = _rays_per_path(scene, cam, cfg)
    paths = cfg.num_pixels * cfg.ns
    mrays = paths * rpp / elapsed / 1e6
    print(f"random-spheres 1200x800@100spp: {elapsed:.3f} s "
          f"({paths / elapsed / 1e6:.1f} Mpaths/s, {mrays:.1f} Mrays/s, "
          f"mean={img.mean():.4f})", file=sys.stderr)

    # config 2 on the same warm executable (ns is dynamic)
    t2, _ = _render(scene, cam, cfg, 10)
    print(f"random-spheres 1200x800@10spp: {t2:.3f} s", file=sys.stderr)
    return elapsed, mrays, t2


def bench_staircase():
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.mesh import procedural_staircase_scene

    gcfg = RenderConfig(nx=96, ny=64, ns=4, max_depth=8)
    gscene, gcam = procedural_staircase_scene(gcfg.nx, gcfg.ny)
    _oracle_gate("staircase_mesh", gscene, gcam, gcfg,
                 rmse_tol=1e-2, ssim_min=0.97)

    cfg = RenderConfig(nx=1200, ny=800, ns=100, max_depth=64)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny)
    elapsed, img = _render(scene, cam, cfg, 100)
    gate("staircase_toy_100spp", img)
    print(f"staircase-toy 1200x800@100spp: {elapsed:.3f} s "
          f"(mean={img.mean():.4f})", file=sys.stderr)
    return elapsed


def _zoo_cell(label, name, scene, cam, cfg):
    """Time one 512x512 zoo frame; returns seconds per spp."""
    elapsed, img = _render(scene, cam, cfg, cfg.ns)
    gate(name, img)
    print(f"{label} 512x512@{cfg.ns}spp: {elapsed:.3f} s "
          f"({elapsed / cfg.ns * 1e3:.0f} ms/spp, mean={img.mean():.4f})",
          file=sys.stderr)
    return elapsed / cfg.ns


def bench_dragon():
    """Dragon-class large mesh: 872k-tri knot at 512x512 (the reference's
    own model-zoo headline row is the 871k-tri dragon, TODO.txt:288 —
    ~24 ms/spp on a GTX 1050)."""
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.shapes import knot_zoo_scene

    cfg = RenderConfig(nx=512, ny=512, ns=4, max_depth=50, textures=False)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, nu=1664, nv=262)
    return _zoo_cell("dragon-class 872k", "dragon_4spp", scene, cam, cfg)


def bench_terrain():
    """Irregular-mesh zoo scene (fBm terrain + thin-strut lattice,
    ~168k tris)."""
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.shapes import terrain_zoo_scene

    cfg = RenderConfig(nx=512, ny=512, ns=8, max_depth=50, textures=False)
    scene, cam = terrain_zoo_scene(cfg.nx, cfg.ny)
    return _zoo_cell("terrain-168k", "terrain_8spp", scene, cam, cfg)


def bench_terrain_big():
    """Dragon-scale irregular mesh (~668k real tris). Reference scale
    anchor: the model-zoo dragon row, TODO.txt:283–298."""
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.shapes import terrain_big_zoo_scene

    cfg = RenderConfig(nx=512, ny=512, ns=4, max_depth=50, textures=False)
    scene, cam = terrain_big_zoo_scene(cfg.nx, cfg.ny)
    return _zoo_cell("terrain-big-668k", "terrain_big_4spp", scene, cam,
                     cfg)


def bench_rocks():
    """Genuinely irregular dragon-scale mesh (~845k tris): fBm-displaced
    interpenetrating rocks (the knot matches the dragon's COUNT but not
    its BVH hostility; this does both). Reference anchor: the model-zoo
    dragon, ~24 ms/spp, TODO.txt:288."""
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.shapes import rocks_zoo_scene

    gcfg = RenderConfig(nx=64, ny=48, ns=4, max_depth=8, textures=False)
    gscene, gcam = rocks_zoo_scene(gcfg.nx, gcfg.ny, n_big=2, n_small=3,
                                   seed=9)
    _oracle_gate("rocks", gscene, gcam, gcfg, rmse_tol=1e-2, ssim_min=0.97)

    cfg = RenderConfig(nx=512, ny=512, ns=4, max_depth=50, textures=False)
    scene, cam = rocks_zoo_scene(cfg.nx, cfg.ny)
    return _zoo_cell("rocks-845k", "rocks_4spp", scene, cam, cfg)


def bench_staircase_hires():
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.mesh import procedural_staircase_scene
    from tpu_pathtracer.ops.bvh import MESH_LEAF_WIDTH

    cfg = RenderConfig(nx=1200, ny=800, ns=2, max_depth=64)
    scene, cam = procedural_staircase_scene(
        1200, 800, prims_per_leaf=MESH_LEAF_WIDTH, sub=20)
    elapsed, img = _render(scene, cam, cfg, 2)
    gate("staircase_hires_2spp", img)
    print(f"staircase-hires 154k 1200x800@2spp: "
          f"{elapsed:.3f} s ({elapsed / 2 * 1e3:.0f} ms/spp, "
          f"mean={img.mean():.4f})", file=sys.stderr)
    # BASELINE config 4 measured end to end: the full 100 spp on the
    # asset-scale staircase, on the warm executable (ns is dynamic)
    t100, img100 = _render(scene, cam, cfg, 100)
    print(f"config 4 staircase-hires 1200x800@100spp: "
          f"{t100:.1f} s (mean={img100.mean():.4f})", file=sys.stderr)
    return elapsed / 2, t100


def bench_knot():
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.shapes import knot_zoo_scene

    gcfg = RenderConfig(nx=64, ny=48, ns=4, max_depth=8, textures=False)
    gscene, gcam = knot_zoo_scene(gcfg.nx, gcfg.ny, nu=48, nv=24)
    _oracle_gate("knot", gscene, gcam, gcfg, rmse_tol=1e-2, ssim_min=0.97)

    cfg = RenderConfig(nx=512, ny=512, ns=16, max_depth=50, textures=False)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny)
    elapsed, img = _render(scene, cam, cfg, 16)
    gate("knot_16spp", img)
    print(f"knot-102k 512x512@16spp: {elapsed:.3f} s "
          f"(mean={img.mean():.4f})", file=sys.stderr)
    return elapsed


def _power_limit() -> str:
    """The card's power limit as nvidia-smi reports it (a child process,
    so this process stays the only JAX client on the card)."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


def main():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found "
                         f"{devices[0].platform!r}")
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices),
              "power_limit": _power_limit()}

    from tpu_pathtracer.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    print(f"device: {device}", file=sys.stderr)

    failed = []

    def cell(name, fn):
        try:
            return fn()
        except Exception as e:  # report every cell, then fail the run
            print(f"{name} bench failed: {e!r}"[:300], file=sys.stderr)
            failed.append(name)
            return None

    extra = {}
    head = cell("headline", bench_headline)
    if head is not None:
        extra["config2_random_spheres_10spp_s"] = round(head[2], 4)
        extra["config2_vs_baseline"] = round(BASELINE_10SPP / head[2], 3)
    for key, name, fn, scale in (
            ("staircase_toy_100spp_s", "staircase", bench_staircase, 1),
            ("zoo_knot_102k_512_16spp_s", "knot", bench_knot, 1),
            ("dragon_872k_ms_per_spp", "dragon", bench_dragon, 1e3),
            ("terrain_168k_ms_per_spp", "terrain", bench_terrain, 1e3),
            ("terrain_big_668k_ms_per_spp", "terrain-big",
             bench_terrain_big, 1e3),
            ("rocks_845k_ms_per_spp", "rocks", bench_rocks, 1e3)):
        v = cell(name, fn)
        if v is not None:
            extra[key] = round(v * scale, 4)
    hires = cell("staircase-hires", bench_staircase_hires)
    if hires is not None:
        extra["staircase_hires_154k_s_per_spp"] = round(hires[0], 4)
        extra["config4_staircase_100spp_s"] = round(hires[1], 2)

    if failed:
        print(f"failed cells: {failed}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({
        "metric": "random_spheres_1200x800_100spp_wall_clock",
        "value": round(head[0], 4),
        "unit": "seconds",
        "vs_baseline": round(BASELINE_100SPP / head[0], 3),
        "mrays_per_sec": round(head[1], 2),
        "device": device,
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
