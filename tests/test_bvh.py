"""BVH: builder invariants, serialization round-trip, traversal == brute
force (the traversal's oracle, mirroring the reference's no-BVH path)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import bvh_cases
from tpu_pathtracer.ops import bvh as B
from tpu_pathtracer.ops.vec import FLT_MAX


def _random_tris(n, seed=0, scale=10.0):
    rng = np.random.RandomState(seed)
    base = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    return base, base + e1, base + e2


def _random_rays(n, seed=1, scale=14.0):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    target = rng.uniform(-8.0, 8.0, size=(n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_builder_invariants():
    v0, v1, v2 = _random_tris(333)
    mesh = B.build_bvh(v0, v1, v2, prims_per_leaf=5)
    # complete implicit heap: first_leaf == num_nodes / 2 (kernels.cu:614)
    assert mesh.bvh_min.shape[0] == 2 * mesh.first_leaf
    assert mesh.num_tris == mesh.first_leaf * mesh.prims_per_leaf
    # every real triangle appears exactly once
    finite = np.isfinite(np.asarray(mesh.v0)).all(-1)
    assert finite.sum() == 333
    # root bounds contain all real triangles
    allv = np.concatenate([np.asarray(mesh.v0)[finite],
                           np.asarray(mesh.v1)[finite],
                           np.asarray(mesh.v2)[finite]])
    assert np.all(allv >= np.asarray(mesh.bounds_min) - 1e-4)
    assert np.all(allv <= np.asarray(mesh.bounds_max) + 1e-4)
    # parent boxes contain child boxes
    bmin = np.asarray(mesh.bvh_min)
    bmax = np.asarray(mesh.bvh_max)
    for i in range(1, mesh.first_leaf):
        assert np.all(bmin[i] <= np.minimum(bmin[2 * i], bmin[2 * i + 1]) + 1e-6)
        assert np.all(bmax[i] >= np.maximum(bmax[2 * i], bmax[2 * i + 1]) - 1e-6)


def test_traversal_matches_brute_force():
    v0, v1, v2 = _random_tris(500)
    mesh = B.build_bvh(v0, v1, v2, prims_per_leaf=5)
    o, d = _random_rays(512)
    a = B.traverse(mesh, o, d, 1e-3, FLT_MAX)
    b = B.brute_force(mesh, o, d, 1e-3, FLT_MAX)
    np.testing.assert_allclose(np.asarray(a.t), np.asarray(b.t), rtol=1e-5)
    hit = np.asarray(b.tri_id) >= 0
    assert hit.sum() > 50  # sanity: the scene is actually being hit
    np.testing.assert_array_equal(np.asarray(a.tri_id)[hit],
                                  np.asarray(b.tri_id)[hit])


def test_shadow_traversal_any_hit():
    v0, v1, v2 = _random_tris(200)
    mesh = B.build_bvh(v0, v1, v2, prims_per_leaf=5)
    o, d = _random_rays(256, seed=3)
    full = B.traverse(mesh, o, d, 1e-3, FLT_MAX)
    shadow = B.traverse(mesh, o, d, 1e-3, FLT_MAX, is_shadow=True)
    np.testing.assert_array_equal(np.asarray(full.tri_id) >= 0,
                                  np.asarray(shadow.tri_id) >= 0)


def test_bvh_file_roundtrip(tmp_path):
    v0, v1, v2 = _random_tris(77)
    tc = np.random.RandomState(2).rand(77, 6).astype(np.float32)
    mid = (np.arange(77) % 20).astype(np.int32)
    mesh = B.build_bvh(v0, v1, v2, tc, mid, prims_per_leaf=5)
    path = os.path.join(tmp_path, "t.bvh")
    B.save_bvh_file(path, mesh)
    back = B.load_bvh_file(path)
    assert back.first_leaf == mesh.first_leaf
    assert back.prims_per_leaf == mesh.prims_per_leaf
    np.testing.assert_array_equal(np.asarray(back.v0), np.asarray(mesh.v0))
    np.testing.assert_array_equal(np.asarray(back.tex_coords),
                                  np.asarray(mesh.tex_coords))
    np.testing.assert_array_equal(np.asarray(back.mesh_id),
                                  np.asarray(mesh.mesh_id))
    np.testing.assert_array_equal(np.asarray(back.bvh_min),
                                  np.asarray(mesh.bvh_min))
    np.testing.assert_allclose(np.asarray(back.bounds_max),
                               np.asarray(mesh.bounds_max))


def test_traversal_respects_t_max():
    v0, v1, v2 = _random_tris(100)
    mesh = B.build_bvh(v0, v1, v2)
    o, d = _random_rays(128, seed=5)
    full = B.traverse(mesh, o, d, 1e-3, FLT_MAX)
    t = np.asarray(full.t)
    hit = np.asarray(full.tri_id) >= 0
    # cap t_max below each hit: those hits must disappear
    capped = B.traverse(mesh, o, d, 1e-3,
                        jnp.asarray(np.where(hit, t * 0.5, 1e30), jnp.float32))
    assert not np.any((np.asarray(capped.tri_id) >= 0) & hit
                      & (np.asarray(capped.t) >= t))


def test_builders_render_equivalently():
    """SAH (native, compiled on demand) and median orders are different
    trees over the same triangles: traversal results must agree with each
    other (via each one's brute-force oracle) for every ray."""
    import pytest

    from tpu_pathtracer import native as nat

    if nat._load() is None:  # pragma: no cover - g++ unavailable
        pytest.skip("native SAH builder unavailable")
    v0, v1, v2 = _random_tris(700, seed=7)
    o, d = _random_rays(512, seed=8)
    results = []
    for builder in ("median", "sah"):
        mesh = B.build_bvh(v0, v1, v2, prims_per_leaf=5, builder=builder)
        r = B.traverse(mesh, o, d, 1e-3, FLT_MAX)
        br = B.brute_force(mesh, o, d, 1e-3, FLT_MAX)
        np.testing.assert_array_equal(np.asarray(r.t), np.asarray(br.t))
        results.append(np.asarray(r.t))
    # the two trees order triangles differently -> fp-identical t values
    # (each triangle's MT math is order-independent; only ties could
    # differ, and the random soup has none)
    np.testing.assert_allclose(results[0], results[1], rtol=1e-6)


def test_single_node_traversal_matches_dual():
    """The single-node stackless walk (kernels.cu:227-294 completeness
    port) must produce identical hits to the dual-node bitstack
    traversal — results are traversal-order-independent; only step
    counts differ (and it fetches one node per step: nodes_both==0)."""
    v0, v1, v2 = _random_tris(400, seed=9)
    mesh = B.build_bvh(v0, v1, v2, prims_per_leaf=5)
    o, d = _random_rays(300, seed=10)
    dual = B.traverse(mesh, o, d, 1e-3, FLT_MAX)
    single = B.traverse_single_node(mesh, o, d, 1e-3, FLT_MAX)
    np.testing.assert_array_equal(np.asarray(dual.tri_id),
                                  np.asarray(single.tri_id))
    np.testing.assert_array_equal(np.asarray(dual.t),
                                  np.asarray(single.t))
    np.testing.assert_array_equal(np.asarray(dual.u),
                                  np.asarray(single.u))
    hit = np.asarray(dual.tri_id) >= 0
    assert hit.sum() > 50
    assert int(single.nodes_both) == 0
    assert int(single.nodes_single) > 0
    # the reference found single-node ~2x the work (TODO.txt:527):
    # one fetch per step, but strictly more steps than dual descents
    assert int(single.nodes_single) > int(dual.nodes_both)

    # shadow semantics: occlusion equal (first-hit identity may differ
    # by order; the boolean cannot)
    sh_d = B.traverse(mesh, o, d, 1e-3, FLT_MAX, is_shadow=True)
    sh_s = B.traverse_single_node(mesh, o, d, 1e-3, FLT_MAX,
                                  is_shadow=True)
    np.testing.assert_array_equal(np.asarray(sh_d.tri_id) >= 0,
                                  np.asarray(sh_s.tri_id) >= 0)

    # t_max respected identically
    t = np.asarray(dual.t)
    capped = B.traverse_single_node(
        mesh, o, d, 1e-3,
        jnp.asarray(np.where(hit, t * 0.5, 1e30), np.float32))
    assert not np.any((np.asarray(capped.tri_id) >= 0) & hit
                      & (np.asarray(capped.t) >= t))


@pytest.fixture(scope="module", params=bvh_cases.LEAF_WIDTHS)
def soup_case(request):
    v0, v1, v2 = _random_tris(700, seed=3)
    o, d = _random_rays(256, seed=4)
    return bvh_cases.case(v0, v1, v2, None, request.param, o, d)


def test_soup_traverse_nearest_vs_brute_force(soup_case):
    bvh_cases.check_nearest(*soup_case)


def test_soup_traverse_anyhit_vs_brute_force(soup_case):
    bvh_cases.check_anyhit(*soup_case)
