"""Torus-knot tube (the smooth parametric zoo mesh): BVH-traversal
exactness at every leaf width, the regen engine, and the tile-sharded
regen render against the single-device one."""

import numpy as np
import pytest

import bvh_cases
from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.engine.regen import render_image_regen
from tpu_pathtracer.engine.render import render_image
from tpu_pathtracer.models.shapes import knot_zoo_scene, torus_knot_mesh
from tpu_pathtracer.utils import golden


@pytest.fixture(scope="module", params=bvh_cases.LEAF_WIDTHS)
def knot_case(request):
    v0, v1, v2, tc = torus_knot_mesh(nu=96, nv=16)
    o, d = bvh_cases.rays(256, 21, (-12, -12, -12), (12, 12, 12),
                          (-3, -3, -1), (3, 3, 1))
    return bvh_cases.case(v0, v1, v2, tc, request.param, o, d)


def test_knot_traverse_nearest_vs_brute_force(knot_case):
    bvh_cases.check_nearest(*knot_case)


def test_knot_traverse_anyhit_vs_brute_force(knot_case):
    bvh_cases.check_anyhit(*knot_case)


def _small_scene(cfg):
    return knot_zoo_scene(cfg.nx, cfg.ny, nu=48, nv=12, prims_per_leaf=8)


def test_knot_regen_matches_plain():
    cfg = RenderConfig(nx=24, ny=16, ns=2, max_depth=4, rays_per_chunk=128,
                       textures=False)
    scene, cam = _small_scene(cfg)
    a = render_image(scene, cam, cfg)
    b = render_image_regen(scene, cam, cfg)
    assert golden.rmse(a, b) < 1e-6  # same paths; only fp sum order


def test_knot_tiled_regen_matches_single_device():
    """The mesh path sharded over the 8 virtual devices equals the
    single-device regen render (RNG keyed by global pixel id)."""
    from tpu_pathtracer.parallel.tiles import render_image_tiled_regen

    cfg = RenderConfig(nx=24, ny=16, ns=2, max_depth=4, rays_per_chunk=64,
                       textures=False)
    scene, cam = _small_scene(cfg)
    single = render_image_regen(scene, cam, cfg)
    tiled = render_image_tiled_regen(scene, cam, cfg)
    np.testing.assert_allclose(single, tiled, rtol=0, atol=1e-6)
