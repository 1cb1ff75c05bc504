"""Multi-device tiling: tile-sharded render must equal the single-device
render bit-for-bit (SURVEY §4 rebuild plan item e) — guaranteed by
global-pixel-id RNG keying."""

import jax
import numpy as np

from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.engine.render import render_image
from tpu_pathtracer.models.mesh import procedural_staircase_scene
from tpu_pathtracer.models.spheres import three_sphere_scene
from tpu_pathtracer.parallel.tiles import render_image_tiled


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8  # conftest forces 8 CPU devices


def test_tiled_equals_single_device_spheres():
    cfg = RenderConfig(nx=40, ny=32, ns=2, max_depth=6)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    single = render_image(scene, cam, cfg)
    tiled = render_image_tiled(scene, cam, cfg)
    np.testing.assert_array_equal(single, tiled)


def test_tiled_equals_single_device_mesh():
    cfg = RenderConfig(nx=32, ny=24, ns=2, max_depth=4)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny)
    single = render_image(scene, cam, cfg)
    tiled = render_image_tiled(scene, cam, cfg)
    np.testing.assert_array_equal(single, tiled)


def test_tiled_sample_batching():
    """Sample batches must partition the sample stream, not repeat it."""
    cfg = RenderConfig(nx=24, ny=16, ns=4, max_depth=4)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    whole = render_image_tiled(scene, cam, cfg)
    batched = render_image_tiled(scene, cam, cfg.replace(samples_per_batch=1))
    np.testing.assert_allclose(whole, batched, atol=1e-6)


def test_tiled_subset_of_devices():
    cfg = RenderConfig(nx=24, ny=16, ns=2, max_depth=4)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    d2 = render_image_tiled(scene, cam, cfg, devices=jax.devices()[:2])
    d8 = render_image_tiled(scene, cam, cfg)
    np.testing.assert_array_equal(d2, d8)


def test_tiled_regen_matches_single():
    from tpu_pathtracer.engine.regen import render_image_regen
    from tpu_pathtracer.parallel.tiles import render_image_tiled_regen

    cfg = RenderConfig(nx=32, ny=16, ns=2, max_depth=5, rays_per_chunk=128)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    single = render_image_regen(scene, cam, cfg)
    tiled = render_image_tiled_regen(scene, cam, cfg)
    np.testing.assert_allclose(single, tiled, atol=1e-6)


def test_tiled_stats_psum():
    cfg = RenderConfig(nx=16, ny=16, ns=2, max_depth=6, stats=True)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    img, stats = render_image_tiled(scene, cam, cfg, report_stats=True)
    assert stats["primary"] if isinstance(stats, dict) else stats.primary \
        == 16 * 16 * 2


def test_config5_dress_rehearsal_tiled_checkpointed_resume(tmp_path):
    """BASELINE config 5 at dryrun scale: a tiled (8 virtual devices) +
    checkpointed + interrupted + resumed render equals a straight
    single-device run exactly (up to fp summation order)."""
    from tpu_pathtracer.engine.regen import render_image_regen
    from tpu_pathtracer.utils import checkpoint as ck

    cfg = RenderConfig(nx=48, ny=24, ns=6, max_depth=5, rays_per_chunk=128)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    straight = render_image_regen(scene, cam, cfg)

    p = str(tmp_path / "c5.ckpt")
    # interrupted run: 4 of 6 samples, tiled over all 8 devices
    ck.render_with_checkpoints(scene, cam, cfg.replace(ns=4), p, batch=2,
                               devices=jax.devices())
    # resume to completion, still tiled
    img = ck.render_with_checkpoints(scene, cam, cfg, p, batch=2,
                                     devices=jax.devices())
    np.testing.assert_allclose(img, straight, atol=1e-5)


