"""Irregular-mesh (terrain + strut lattice) tests.

Every other zoo mesh is a smooth parametric tube; the terrain scene is
the non-parametric stress case: fBm-displaced, vertex-jittered
tessellation plus thin-feature struts. These tests pin (a) mesh
validity, (b) exactness of the BVH traversal on this topology at every
leaf width, (c) the regen engine and the node counters on it, and (d)
an end-to-end render against a committed golden.
"""

import jax
import numpy as np
import pytest

import bvh_cases
from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.engine.regen import render_image_regen, render_regen
from tpu_pathtracer.engine.render import render_image
from tpu_pathtracer.models.shapes import terrain_mesh, terrain_zoo_scene
from tpu_pathtracer.utils import golden


@pytest.fixture(scope="module", params=bvh_cases.LEAF_WIDTHS)
def terrain_case(request):
    v0, v1, v2, tc = terrain_mesh(n=32, struts=40)
    o, d = bvh_cases.rays(256, 11, (-9, 1, -9), (9, 8, 9), (-7, 0, -7),
                          (7, 4, 7))
    return bvh_cases.case(v0, v1, v2, tc, request.param, o, d)


def test_terrain_traverse_nearest_vs_brute_force(terrain_case):
    bvh_cases.check_nearest(*terrain_case, min_hits=50)


def test_terrain_traverse_anyhit_vs_brute_force(terrain_case):
    bvh_cases.check_anyhit(*terrain_case)


def _small_scene(cfg):
    return terrain_zoo_scene(cfg.nx, cfg.ny, n=24, struts=20,
                             prims_per_leaf=8)


def test_terrain_regen_matches_plain():
    cfg = RenderConfig(nx=24, ny=16, ns=2, max_depth=4, rays_per_chunk=128,
                       textures=False)
    scene, cam = _small_scene(cfg)
    a = render_image(scene, cam, cfg)
    b = render_image_regen(scene, cam, cfg)
    assert golden.rmse(a, b) < 1e-6  # same paths; only fp sum order


def test_terrain_node_counters():
    """Per-ray traversal step counters fire, and the regen engine
    accounts them exactly like the plain engine."""
    cfg = RenderConfig(nx=16, ny=12, ns=1, max_depth=3, stats=True,
                       rays_per_chunk=96, textures=False)
    scene, cam = _small_scene(cfg)
    _, plain = render_image(scene, cam, cfg, report_stats=True)
    _, regen = jax.jit(lambda s, c: render_regen(s, c, cfg))(scene, cam)
    assert int(plain.nodes_both) > 0 and int(plain.nodes_single) > 0
    assert int(regen.nodes_both) == int(plain.nodes_both)
    assert int(regen.nodes_single) == int(plain.nodes_single)


def test_terrain_mesh_shape_and_irregularity():
    v0, v1, v2, tc = terrain_mesh(n=48, struts=60)
    n_tris = v0.shape[0]
    assert n_tris >= 2 * 47 * 47  # grid tris + kept struts
    for a in (v0, v1, v2, tc):
        assert np.isfinite(a).all()
    # irregular tessellation: edge lengths genuinely vary (no two
    # congruent rows of triangles, unlike the parametric tubes)
    e = np.linalg.norm(v1[: 2 * 47 * 47] - v0[: 2 * 47 * 47], axis=1)
    assert e.std() / e.mean() > 0.15
    # thin features exist: strut cross-section chords (2r·sin60°,
    # r ≤ 0.05) are tiny. Strut tris are the tail of the buffer; take
    # the min edge over all three edges since block order interleaves
    # cross-section and axis edges.
    n_strut = n_tris - 2 * 47 * 47
    sv0, sv1, sv2 = v0[-n_strut:], v1[-n_strut:], v2[-n_strut:]
    edges = np.concatenate([np.linalg.norm(sv1 - sv0, axis=1),
                            np.linalg.norm(sv2 - sv1, axis=1),
                            np.linalg.norm(sv0 - sv2, axis=1)])
    assert edges.min() < 0.15


def test_terrain_committed_golden():
    """Small terrain-scene render vs committed golden .ref (the
    reference's regression mechanism, main.cpp:117-126)."""
    cfg = RenderConfig(nx=32, ny=24, ns=2, max_depth=6,
                       rays_per_chunk=256, textures=False)
    scene, cam = terrain_zoo_scene(cfg.nx, cfg.ny, n=40, struts=50,
                                   prims_per_leaf=8)
    img = render_image(scene, cam, cfg)
    assert np.isfinite(np.asarray(img)).all()
    ref = golden.load_reference("assets/terrain_32x24_2spp.ref", 32, 24)
    assert golden.rmse(img, ref) < 1e-6
    assert golden.ssim(img, ref) > 0.9999
