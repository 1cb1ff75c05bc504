"""``ops.intersect.spheres_hit`` — the sphere-set intersection on the hot
path of the sphere scenes — against a NumPy per-ray loop in float64,
nearest and any-hit, across sphere counts that cross its 512-sphere
chunk and a ray count that is no multiple of anything."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pathtracer.ops.intersect import spheres_hit
from tpu_pathtracer.ops.vec import FLT_MAX

T_MIN = 0.01
EPS32 = float(np.finfo(np.float32).eps)


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _spheres(s, seed):
    rng = np.random.RandomState(seed)
    c = rng.uniform(-10, 10, (s, 3)).astype(np.float32)
    r = rng.uniform(0.3, 2.0, s).astype(np.float32)
    if s == 1:
        c[0], r[0] = (0.0, 0.0, 0.0), 6.0  # one sphere most rays meet
    else:
        c[0] = (0.0, -1000.0, 0.0)  # a ground sphere, as in the headline
        r[0] = 995.0
    return c, r


def per_ray_reference(o, d, c, r, t_max):
    """Nearest admissible root per ray, a Python loop over rays in float64
    (intersections.h:85–104). Returns (t, index, tolerance, grazing): the
    tolerance is the float32 error of the quadratic at the winner — the
    root cancels when |b| is large and sqrt amplifies a small
    discriminant — and grazing marks a discriminant within float32
    rounding of zero, where hit and miss may legitimately flip."""
    n = o.shape[0]
    t = np.full(n, np.inf)
    idx = np.zeros(n, np.int64)
    tol = np.zeros(n)
    grazing = np.zeros(n, bool)
    c64, r64 = c.astype(np.float64), r.astype(np.float64)
    for k in range(n):
        oc = o[k].astype(np.float64) - c64
        b = oc @ d[k].astype(np.float64)
        oc2 = np.sum(oc * oc, axis=1)
        disc = b * b - (oc2 - r64 * r64)
        sq = np.sqrt(np.maximum(disc, 0.0))
        ok = (r64 > 0) & (disc > 0)
        t1, t2 = -b - sq, -b + sq
        t1 = np.where(ok & (t1 > T_MIN) & (t1 < t_max[k]), t1, np.inf)
        t2 = np.where(ok & (t2 > T_MIN) & (t2 < t_max[k]), t2, np.inf)
        ts = np.minimum(t1, t2)
        j = int(np.argmin(ts))
        scale = b * b + oc2 + r64 * r64
        band = 8 * EPS32 * scale
        grazing[k] = bool(np.any(np.abs(disc) <= band))
        t[k], idx[k] = ts[j], j
        tol[k] = 4 * EPS32 * (abs(b[j]) + np.sqrt(oc2[j]) + scale[j]
                              / (2 * max(sq[j], 1e-30)))
    return t, idx, tol, grazing


# ray count deliberately no multiple of a power of two
N_RAYS = 301


@pytest.mark.parametrize("mode", ["nearest", "anyhit"])
@pytest.mark.parametrize("num_spheres", [1, 3, 127, 488, 1025])
def test_spheres_hit_matches_per_ray_loop(num_spheres, mode):
    c, r = _spheres(num_spheres, seed=num_spheres)
    o, d = _rays(N_RAYS, seed=num_spheres + 1)
    big = np.full(N_RAYS, np.inf)
    t_ref, i_ref, tol, grazing = per_ray_reference(o, d, c, r, big)
    hit = np.isfinite(t_ref)
    assert hit.any()
    if mode == "nearest":
        t, i = spheres_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                           jnp.asarray(r), T_MIN, FLT_MAX)
        t, i = np.asarray(t, np.float64), np.asarray(i)
        got = t < 1e30
        np.testing.assert_array_equal(got[~grazing], hit[~grazing])
        both = got & hit
        err = np.abs(t - t_ref)
        # t to rtol 1e-5, or within the float32 error of the quadratic
        assert np.all(((err <= 1e-5 * t_ref) | (err <= tol))[both])
        # a different winner only where the two candidates tie in float32
        diff = both & (i != i_ref)
        assert np.all(err[diff] <= np.maximum(1e-5 * t_ref, tol)[diff])
        assert (i[~got] == 0).all()  # a miss reports index 0
    else:
        # caps on alternate sides of the nearest hit: occluded exactly
        # when that hit lies below the cap
        side = np.where(np.arange(N_RAYS) % 2 == 0, 0.5, 2.0)
        cap = np.where(hit, t_ref * side, 1e3).astype(np.float32)
        t, _ = spheres_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                           jnp.asarray(r), T_MIN, jnp.asarray(cap))
        occ = np.asarray(t) < cap
        np.testing.assert_array_equal(occ[~grazing],
                                      (hit & (side > 1.0))[~grazing])


def test_spheres_hit_per_ray_tmax():
    """A per-ray t_max below each ray's nearest hit removes every hit."""
    c, r = _spheres(16, seed=2)
    o, d = _rays(128, seed=3)
    t1, _ = spheres_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                        jnp.asarray(r), T_MIN, FLT_MAX)
    hit = np.asarray(t1) < 1e30
    assert hit.sum() > 10
    tm = jnp.asarray(np.where(hit, np.asarray(t1) * 0.5, 1e38), jnp.float32)
    t2, _ = spheres_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                        jnp.asarray(r), T_MIN, tm)
    assert not np.any(np.asarray(t2)[hit] < 1e30)


def test_spheres_hit_ignores_nonpositive_radii():
    """Radius <= 0 marks padding and never hits, even for a ray aimed at
    the centre."""
    c = jnp.asarray([[0.0, 0.0, -5.0], [0.0, 0.0, -9.0]], jnp.float32)
    r = jnp.asarray([0.0, 1.0], jnp.float32)
    o = jnp.zeros((1, 3), jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    t, i = spheres_hit(o, d, c, r, T_MIN, FLT_MAX)
    assert int(i[0]) == 1
    np.testing.assert_allclose(float(t[0]), 8.0, rtol=1e-6)
