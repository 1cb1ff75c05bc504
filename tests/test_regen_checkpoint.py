"""Regeneration engine + checkpoint/resume."""

import os

import numpy as np

from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.engine.regen import render_image_regen, render_sample_range
from tpu_pathtracer.engine.render import render_image
from tpu_pathtracer.models.mesh import procedural_staircase_scene
from tpu_pathtracer.models.spheres import three_sphere_scene
from tpu_pathtracer.utils import checkpoint as ck
from tpu_pathtracer.utils.golden import rmse


def test_regen_matches_plain_spheres():
    cfg = RenderConfig(nx=48, ny=32, ns=8, max_depth=8, rays_per_chunk=512)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    a = render_image(scene, cam, cfg)
    b = render_image_regen(scene, cam, cfg)
    assert rmse(a, b) < 1e-6  # identical paths; only fp sum order differs


def test_regen_matches_plain_mesh_nee():
    cfg = RenderConfig(nx=32, ny=24, ns=4, max_depth=5, rays_per_chunk=256)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny)
    a = render_image(scene, cam, cfg)
    b = render_image_regen(scene, cam, cfg)
    assert rmse(a, b) < 1e-6


def test_regen_dynamic_ns():
    cfg = RenderConfig(nx=32, ny=16, ns=4, max_depth=6, rays_per_chunk=256)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    a = render_image_regen(scene, cam, cfg, ns=2)
    b = render_image(scene, cam, cfg.replace(ns=2))
    assert rmse(a, b) < 1e-6


def test_sample_ranges_partition():
    """Sum over [0,2) + sum over [2,4) == 4 * mean over [0,4)."""
    cfg = RenderConfig(nx=24, ny=16, ns=4, max_depth=6, rays_per_chunk=256)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    whole = render_image_regen(scene, cam, cfg) * 4.0
    parts = (render_sample_range(scene, cam, cfg, 0, 2)
             + render_sample_range(scene, cam, cfg, 2, 2))
    np.testing.assert_allclose(whole, parts, atol=1e-4)


def test_regen_flush_window_bit_identical():
    """The sliding flush window (flush_window=W)
    stalls early lanes instead of widening the one-hot — radiance sums
    must be BIT-identical to the full one-hot across many rounds
    (here rounds = n/chunk = 15 > W = 4, so stalls actually occur)."""
    import numpy as np

    from tpu_pathtracer.engine.regen import render_regen
    from tpu_pathtracer.models.spheres import three_sphere_scene

    cfg = RenderConfig(nx=60, ny=16, ns=5, max_depth=6,
                       rays_per_chunk=64, flush_window=0)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    full = np.asarray(render_regen(scene, cam, cfg))
    win = np.asarray(render_regen(scene, cam,
                                  cfg.replace(flush_window=4)))
    np.testing.assert_array_equal(full, win)


def test_regen_stats():
    import jax
    from tpu_pathtracer.engine.regen import render_regen

    cfg = RenderConfig(nx=16, ny=8, ns=2, max_depth=6, stats=True,
                       check_nans=True, rays_per_chunk=64)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    fb, stats = jax.jit(lambda s, c: render_regen(s, c, cfg))(scene, cam)
    assert int(stats.primary) == 16 * 8 * 2
    assert int(stats.secondary) > 0
    # must match the plain engine's accounting exactly — all counters
    _, plain = render_image(scene, cam, cfg, report_stats=True)
    for k in stats._fields:
        assert int(getattr(stats, k)) == int(getattr(plain, k)), k


def test_full_stats_matrix_mesh_scene():
    """The 18-counter matrix (kernels.cu:48–66) on a mesh+NEE scene:
    regen == plain for every counter, and the mesh-specific counters
    actually fire."""
    import jax
    from tpu_pathtracer.engine.regen import render_regen

    cfg = RenderConfig(nx=24, ny=16, ns=2, max_depth=6, stats=True,
                       check_nans=True, rays_per_chunk=128)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny)
    _, plain = render_image(scene, cam, cfg, report_stats=True)
    _, stats = jax.jit(lambda s, c: render_regen(s, c, cfg))(scene, cam)
    for k in stats._fields:
        assert int(getattr(stats, k)) == int(getattr(plain, k)), k
    assert int(plain.primary) == 24 * 16 * 2
    assert int(plain.primary_hit_mesh) > 0
    assert int(plain.secondary_mesh) > 0
    assert int(plain.shadows) > 0
    # reference quirk: primary_nohit includes primary non-mesh hits
    assert (int(plain.primary_nohit) + int(plain.primary_hit_mesh)
            >= int(plain.primary))


def test_nodes_counters_on_traversal_path():
    """nodes_both/nodes_single fire on the jnp BVH traversal (the CPU
    large-mesh path)."""
    from tpu_pathtracer.models.shapes import knot_zoo_scene

    cfg = RenderConfig(nx=12, ny=8, ns=1, max_depth=3, stats=True,
                       rays_per_chunk=96, textures=False)
    scene, cam = knot_zoo_scene(cfg.nx, cfg.ny, nu=48, nv=12,
                                prims_per_leaf=8)
    _, stats = render_image(scene, cam, cfg, report_stats=True)
    assert int(stats.nodes_both) > 0
    assert int(stats.nodes_single) > 0
    assert int(stats.primary_bbox_nohit) > 0  # rays that miss the knot


def test_preset_materials_render_vs_oracle():
    """Scene using the reference's preset BSDF families (coat, tinted
    glass, subsurface, checker) end-to-end vs the oracle."""
    import numpy as np

    from tpu_pathtracer.models.presets import (floor_checker, model_coat,
                                               model_sss,
                                               model_tinted_glass)
    from tpu_pathtracer.models.scene import SKY_GRADIENT, make_materials, \
        make_scene
    from tpu_pathtracer.camera import make_camera
    from tpu_pathtracer.oracle import render_oracle

    mats = make_materials([floor_checker(), model_coat(),
                           model_tinted_glass(), model_sss()])
    centers = np.array([[0.0, -100.5, -1.0], [-1.05, 0.0, -1.0],
                        [0.0, 0.0, -1.0], [1.05, 0.0, -1.0]], np.float32)
    radii = np.array([100.0, 0.5, 0.5, 0.5], np.float32)
    scene = make_scene(mats, sphere_center=centers, sphere_radius=radii,
                       sphere_mat=np.arange(4, dtype=np.int32),
                       use_nee=False, sky_mode=SKY_GRADIENT)
    cam = make_camera((0.0, 0.3, 1.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0),
                      60.0, 1.5)
    cfg = RenderConfig(nx=48, ny=32, ns=6, max_depth=8)
    img = render_image(scene, cam, cfg)
    ref = render_oracle(scene, cam, cfg)
    assert rmse(img, ref) < 0.01
    assert abs(float((img - ref).mean())) < 2e-3


def test_checkpoint_roundtrip(tmp_path):
    buf = np.random.RandomState(0).rand(8, 12, 3).astype(np.float32)
    p = str(tmp_path / "c.ckpt")
    ck.save_checkpoint(p, buf, 7, fingerprint=123)
    back, done, fp = ck.load_checkpoint(p)
    assert done == 7
    assert fp == 123
    np.testing.assert_array_equal(back, buf)
    assert ck.load_checkpoint(str(tmp_path / "missing.ckpt")) is None


def test_checkpoint_rejects_mismatch(tmp_path):
    import pytest

    cfg = RenderConfig(nx=16, ny=8, ns=2, max_depth=4, rays_per_chunk=64)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    p = str(tmp_path / "m.ckpt")
    ck.render_with_checkpoints(scene, cam, cfg, p, batch=2)
    # more samples done than the new config asks for → refuse
    with pytest.raises(ValueError, match="samples done"):
        ck.render_with_checkpoints(scene, cam, cfg.replace(ns=1), p, batch=1)
    # different scene → fingerprint mismatch
    import dataclasses
    import jax.numpy as jnp

    scene2, cam2 = three_sphere_scene(cfg.nx, cfg.ny)
    scene2 = dataclasses.replace(
        scene2, light_color=jnp.asarray((9.0, 9.0, 9.0), jnp.float32))
    with pytest.raises(ValueError, match="fingerprint"):
        ck.render_with_checkpoints(scene2, cam, cfg.replace(ns=4), p, batch=2)


def test_render_with_checkpoints_resume(tmp_path):
    cfg = RenderConfig(nx=24, ny=16, ns=6, max_depth=5, rays_per_chunk=256)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    p = str(tmp_path / "r.ckpt")

    # straight run
    full = ck.render_with_checkpoints(scene, cam, cfg, p + ".a", batch=6)
    # interrupted run: do 2 batches of 2, "crash", resume for the rest
    calls = []
    ck.render_with_checkpoints(
        scene, cam, cfg.replace(ns=4), p, batch=2,
        progress=lambda d, t: calls.append(d))
    assert calls == [2, 4]
    # ckpt now holds 4 samples; resume to 6
    resumed = ck.render_with_checkpoints(scene, cam, cfg, p, batch=2)
    np.testing.assert_allclose(full, resumed, atol=1e-4)
