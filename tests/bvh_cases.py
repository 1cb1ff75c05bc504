"""Shared checks of ``ops.bvh.traverse`` against the all-triangles
``brute_force`` oracle (the reference's no-BVH path, kernels.cu:307–321),
used by each mesh family's test file at every leaf width."""

import jax.numpy as jnp
import numpy as np

from tpu_pathtracer.ops import bvh as B
from tpu_pathtracer.ops.vec import FLT_MAX

LEAF_WIDTHS = (4, 8, 16, 64)
T_MIN = 1e-3


def rays(n, seed, origin_lo, origin_hi, target_lo, target_hi):
    """n unit rays from a box of origins towards a box of targets."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(origin_lo, origin_hi, (n, 3)).astype(np.float32)
    tgt = rng.uniform(target_lo, target_hi, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def build(v0, v1, v2, tc, prims_per_leaf):
    return B.build_bvh(v0, v1, v2, tc, np.ones((v0.shape[0],), np.int32),
                       prims_per_leaf=prims_per_leaf)


def case(v0, v1, v2, tc, prims_per_leaf, o, d):
    """(mesh, origins, directions, brute-force nearest hits)."""
    mesh = build(v0, v1, v2, tc, prims_per_leaf)
    return mesh, o, d, B.brute_force(mesh, o, d, T_MIN, FLT_MAX)


def check_nearest(mesh, o, d, ref, min_hits=20):
    """Same winner triangle for every ray. t agrees to rtol 1e-4: thin
    sliver triangles make f = 1/a ill-conditioned, and the traversal and
    the brute-force scan compile as separate programs whose FMA
    contraction may differ."""
    got = B.traverse(mesh, o, d, T_MIN, FLT_MAX)
    hit = np.asarray(ref.tri_id) >= 0
    assert hit.sum() >= min_hits  # the ray set genuinely hits the mesh
    np.testing.assert_array_equal(hit, np.asarray(got.tri_id) >= 0)
    np.testing.assert_array_equal(np.asarray(ref.tri_id)[hit],
                                  np.asarray(got.tri_id)[hit])
    np.testing.assert_allclose(np.asarray(ref.t)[hit],
                               np.asarray(got.t)[hit], rtol=1e-4)


def check_anyhit(mesh, o, d, ref):
    """Any-hit (shadow) traversal with the cap on alternate sides of the
    nearest hit: occluded exactly when the nearest hit is below the cap."""
    t = np.asarray(ref.t)
    hit = np.asarray(ref.tri_id) >= 0
    side = np.where(np.arange(t.size) % 2 == 0, 0.5, 2.0)
    cap = np.where(hit, t * side, 1e3).astype(np.float32)
    got = B.traverse(mesh, o, d, T_MIN, jnp.asarray(cap), is_shadow=True)
    occluded = np.asarray(got.tri_id) >= 0
    np.testing.assert_array_equal(occluded, hit & (side > 1.0))
    assert occluded.any() and not occluded.all()
