"""End-to-end golden tests: the JAX renderer vs the independent NumPy
oracle (SURVEY §4 rebuild plan items a+b), plus golden-file IO and
accumulation-semantics checks."""

import numpy as np
import pytest

from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.engine.render import Renderer, render_image
from tpu_pathtracer.models.mesh import procedural_staircase_scene
from tpu_pathtracer.models.spheres import random_spheres_scene, three_sphere_scene
from tpu_pathtracer.oracle import render_oracle
from tpu_pathtracer.utils import golden


def test_three_sphere_matches_oracle():
    cfg = RenderConfig(nx=48, ny=32, ns=8, max_depth=8)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    img = render_image(scene, cam, cfg)
    ref = render_oracle(scene, cam, cfg)
    assert golden.rmse(img, ref) < 5e-3
    assert golden.ssim(img, ref) > 0.98
    assert abs(float((img - ref).mean())) < 1e-3


def test_staircase_mesh_matches_oracle():
    cfg = RenderConfig(nx=40, ny=50, ns=4, max_depth=5)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny)
    img = render_image(scene, cam, cfg)
    ref = render_oracle(scene, cam, cfg)
    assert golden.rmse(img, ref) < 0.01
    assert golden.ssim(img, ref) > 0.97
    assert abs(float((img - ref).mean())) < 1e-3


def test_baseline_config1_ssim_gate():
    """BASELINE.json config 1 (three-sphere + ground golden) at reduced
    resolution: SSIM >= 0.99 vs the CPU oracle — the north-star acceptance
    gate."""
    cfg = RenderConfig(nx=160, ny=100, ns=4, max_depth=8)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    img = render_image(scene, cam, cfg)
    ref = render_oracle(scene, cam, cfg)
    assert golden.ssim(img, ref) >= 0.99
    assert golden.rmse(img, ref) < 5e-3


def test_bvh_equals_brute_force_end_to_end():
    cfg = RenderConfig(nx=32, ny=40, ns=2, max_depth=4)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny)
    a = render_image(scene, cam, cfg)
    b = render_image(scene, cam, cfg.replace(use_bvh=False))
    np.testing.assert_array_equal(a, b)


def test_random_spheres_smoke():
    cfg = RenderConfig(nx=60, ny=40, ns=2, max_depth=8)
    scene, cam = random_spheres_scene(cfg.nx, cfg.ny)
    assert scene.sphere_center.shape[0] > 400  # ~488 spheres
    img = render_image(scene, cam, cfg)
    assert img.shape == (40, 60, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.05  # scene is lit by the gradient sky


def test_chunking_invariance():
    """Result must not depend on the lane-chunk decomposition."""
    cfg = RenderConfig(nx=40, ny=24, ns=2, max_depth=4)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    a = render_image(scene, cam, cfg)
    b = render_image(scene, cam, cfg.replace(rays_per_chunk=256))
    np.testing.assert_array_equal(a, b)


def test_renderer_lifecycle_and_stats():
    cfg = RenderConfig(nx=32, ny=20, ns=2, max_depth=6, stats=True)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    r = Renderer(scene, cam, cfg)
    fb = r.run()
    assert fb.shape == (20, 32, 3)
    st = r.stats
    assert st.primary == 32 * 20 * 2  # one primary ray per (pixel, sample)
    assert st.secondary > 0
    assert st.primary_nohit + st.secondary_nohit > 0
    r.cleanup()
    assert r.framebuffer is None


def test_golden_file_roundtrip(tmp_path):
    img = np.random.RandomState(0).rand(20, 30, 3).astype(np.float32)
    path = str(tmp_path / "f30-20.ref")
    golden.save_reference(path, img)
    back = golden.load_reference(path, 30, 20)
    np.testing.assert_array_equal(img, back)
    with pytest.raises(ValueError):
        golden.load_reference(path, 31, 20)


def test_rmse_and_ssim_basics():
    a = np.random.RandomState(1).rand(32, 32, 3).astype(np.float32)
    assert golden.rmse(a, a) == 0.0
    assert golden.ssim(a, a) == pytest.approx(1.0, abs=1e-9)
    b = a + 0.1
    assert golden.rmse(a, b) == pytest.approx(0.1, rel=1e-5)


def test_max_depth_zero_is_black():
    cfg = RenderConfig(nx=8, ny=8, ns=1, max_depth=0)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    img = render_image(scene, cam, cfg)
    np.testing.assert_array_equal(img, 0.0)


def test_nee_specular_light_quirk():
    """With NEE on, specular light hits add nothing (kernels.cu:440–446);
    with NEE off they add attenuation*lightColor (kernels.cu:444)."""
    from tpu_pathtracer.models.scene import METAL, make_materials, make_scene

    mats = make_materials([dict(type=METAL, color=(1.0, 1.0, 1.0), param=0.0)])
    # flat mirror plane at z=-2 bounces center rays back into a light
    # sphere behind the camera
    scene_on = make_scene(
        mats, plane_point=(0.0, 0.0, -2.0), plane_norm=(0.0, 0.0, 1.0),
        plane_mat=0, light_center=(0.0, 0.0, 5.0), light_radius=2.0,
        light_color=(7.0, 7.0, 7.0), sky_color=(0.0, 0.0, 0.0), use_nee=True)
    from tpu_pathtracer.camera import make_camera
    cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 40.0, 1.0)
    cfg = RenderConfig(nx=16, ny=16, ns=1, max_depth=4, shadow=True)
    img_on = render_image(scene_on, cam, cfg)
    img_off = render_image(scene_on, cam, cfg.replace(shadow=False))
    # center pixel: camera ray hits mirror, bounces back, hits light sphere
    assert img_on[8, 8].max() == 0.0  # the as-built quirk: no contribution
    assert img_off[8, 8].max() > 1.0  # NEE off: light contributes


def test_staircase_committed_golden():
    """Mesh+BVH+textures+NEE render vs the committed golden .ref — the
    reference's regression mechanism (main.cpp:117–126) on the mesh
    pipeline, not just spheres."""
    from tpu_pathtracer.models.mesh import procedural_staircase_scene

    cfg = RenderConfig(nx=24, ny=16, ns=2, max_depth=6, rays_per_chunk=128)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny)
    img = render_image(scene, cam, cfg)
    ref = golden.load_reference("assets/staircase_24x16_2spp.ref", 24, 16)
    assert golden.rmse(img, ref) < 1e-6
    assert golden.ssim(img, ref) > 0.9999


def test_profiling_measure_reports_rays():
    """utils/profiling.measure: wall timing + exact ray accounting."""
    from tpu_pathtracer.utils.profiling import measure

    cfg = RenderConfig(nx=16, ny=8, ns=2, max_depth=4, rays_per_chunk=64)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    m = measure(scene, cam, cfg, count_rays=True)
    assert m.seconds > 0
    assert m.paths == 16 * 8 * 2
    assert m.rays >= m.paths  # at least one ray per path
    assert m.mrays_per_sec is not None and m.mrays_per_sec > 0
    assert "Mpaths/s" in repr(m)


def test_oracle_pixel_subsets_partition_the_frame():
    """Disjoint pixel-id sets rendered separately (as chip_smoke.py's
    oracle workers do) reassemble the whole-frame oracle render."""
    import numpy as np

    cfg = RenderConfig(nx=16, ny=12, ns=2, max_depth=4)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    whole = render_oracle(scene, cam, cfg)
    ids = np.arange(cfg.num_pixels)
    parts = [render_oracle(scene, cam, cfg, pixels=p)
             for p in np.array_split(ids, 3)]
    np.testing.assert_array_equal(
        np.concatenate(parts).reshape(cfg.ny, cfg.nx, 3), whole)
