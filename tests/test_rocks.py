"""Rock-pile irregular dragon-scale mesh tests.

The 'dragon-class' knot is a smooth parametric tube with near-ideal
BVH locality; the rock pile (fBm-displaced, anisotropically scaled,
deeply interpenetrating icospheres) is the honest irregular topology
at the same triangle count. These tests pin (a) mesh validity and
genuine size irregularity, (b) crack-free displacement (shared edges
displace identically), (c) BVH-traversal exactness on this topology at
every leaf width, (d) the regen engine and node counters on it, and (e)
a small end-to-end render.
"""

import jax
import numpy as np
import pytest

import bvh_cases
from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.engine.regen import render_image_regen, render_regen
from tpu_pathtracer.engine.render import render_image
from tpu_pathtracer.models.shapes import rock_pile_mesh, rocks_zoo_scene
from tpu_pathtracer.utils import golden


def _small_pile():
    return rock_pile_mesh(n_big=2, n_small=3, seed=9)


def test_rock_pile_shape_and_irregularity():
    v0, v1, v2, tc = _small_pile()
    n = v0.shape[0]
    assert n == 2 * 5120 + 3 * 1280
    for a in (v0, v1, v2, tc):
        assert np.isfinite(a).all()
    # triangle areas must span orders of magnitude (the knot's do not)
    e1, e2 = v1 - v0, v2 - v0
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    assert np.percentile(areas, 99) / np.percentile(areas, 5) > 10.0
    # deep overlap: per-rock bounding boxes must intersect each other
    sizes = [5120, 5120, 1280, 1280, 1280]
    lo, hi = [], []
    at = 0
    for s in sizes:
        pts = np.concatenate([v0[at:at + s], v1[at:at + s],
                              v2[at:at + s]])
        lo.append(pts.min(0))
        hi.append(pts.max(0))
        at += s
    overlaps = sum(
        int((np.minimum(hi[i], hi[j]) > np.maximum(lo[i], lo[j])).all())
        for i in range(5) for j in range(i + 1, 5))
    assert overlaps >= 1


def test_rock_pile_no_cracks():
    """Displacement is a pure function of position: every vertex value
    appears in >=2 triangles (faces are stored independently, so a
    per-face noise would break this)."""
    v0, v1, v2, _ = rock_pile_mesh(n_big=0, n_small=1, seed=3)
    pts = np.concatenate([v0, v1, v2])
    _, counts = np.unique(pts.round(5), axis=0, return_counts=True)
    assert (counts >= 2).mean() > 0.99


def test_rocks_scene_renders():
    cfg = RenderConfig(nx=48, ny=32, ns=2, max_depth=5, textures=False)
    scene, cam = rocks_zoo_scene(cfg.nx, cfg.ny, n_big=2, n_small=3,
                                 seed=9)
    img = render_image(scene, cam, cfg)
    assert img.shape == (32, 48, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01


@pytest.fixture(scope="module", params=bvh_cases.LEAF_WIDTHS)
def rocks_case(request):
    v0, v1, v2, tc = _small_pile()
    o, d = bvh_cases.rays(256, 4, (-8, 2, -8), (8, 10, 8), (-4, 0, -4),
                          (4, 3, 4))
    return bvh_cases.case(v0, v1, v2, tc, request.param, o, d)


def test_rocks_traverse_nearest_vs_brute_force(rocks_case):
    bvh_cases.check_nearest(*rocks_case, min_hits=50)


def test_rocks_traverse_anyhit_vs_brute_force(rocks_case):
    bvh_cases.check_anyhit(*rocks_case)


def test_rocks_regen_matches_plain():
    cfg = RenderConfig(nx=24, ny=16, ns=2, max_depth=4, rays_per_chunk=128,
                       textures=False)
    scene, cam = rocks_zoo_scene(cfg.nx, cfg.ny, n_big=0, n_small=2,
                                 seed=9, prims_per_leaf=8)
    a = render_image(scene, cam, cfg)
    b = render_image_regen(scene, cam, cfg)
    assert golden.rmse(a, b) < 1e-6  # same paths; only fp sum order


def test_rocks_node_counters():
    """Per-ray traversal step counters fire, and the regen engine
    accounts them exactly like the plain engine."""
    cfg = RenderConfig(nx=16, ny=12, ns=1, max_depth=3, stats=True,
                       rays_per_chunk=96, textures=False)
    scene, cam = rocks_zoo_scene(cfg.nx, cfg.ny, n_big=0, n_small=2,
                                 seed=9, prims_per_leaf=8)
    _, plain = render_image(scene, cam, cfg, report_stats=True)
    _, regen = jax.jit(lambda s, c: render_regen(s, c, cfg))(scene, cam)
    assert int(plain.nodes_both) > 0 and int(plain.nodes_single) > 0
    assert int(regen.nodes_both) == int(plain.nodes_both)
    assert int(regen.nodes_single) == int(plain.nodes_single)
