"""Batched ray-primitive intersection.

Rebuilds intersections.h (slab AABB :7–41, plane :43–52, Möller–Trumbore
triangle :54–83, sphere :85–104) as fixed-shape vectorized stages.

NaN semantics: C float comparisons with NaN are false, so the reference's
``t0 > t_min ? t0 : t_min`` keeps the accumulator when a slab division
yields NaN (0·inf). ``jnp.maximum`` would propagate the NaN instead, so the
slab test below uses explicit ``where``s to mimic the C ternaries.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from tpu_pathtracer.ops.vec import FLT_MAX, dot, cross

# Matches the reference's inner slab t_min (intersections.h:8, :26).
BBOX_T_MIN = 0.001


def _quadratic_ts(b, c, valid, t_min, t_max):
    """Roots of t² + 2bt + c (a=1), filtered to (t_min, t_max); prefers the
    near root exactly like intersections.h:91–101 (t1 <= t2 so min == the
    reference's try-near-then-far order). Returns FLT_MAX on miss."""
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    ok = valid & (disc > 0.0)
    t1v = jnp.where(ok & (t1 > t_min) & (t1 < t_max), t1, FLT_MAX)
    t2v = jnp.where(ok & (t2 > t_min) & (t2 < t_max), t2, FLT_MAX)
    return jnp.minimum(t1v, t2v)


def spheres_hit(origin: jnp.ndarray, direction: jnp.ndarray,
                centers: jnp.ndarray, radii: jnp.ndarray,
                t_min, t_max) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Nearest hit among S spheres for N rays (intersections.h:85–104).

    Direct ``oc = o - center`` form (full f32 precision, identical to the
    reference), chunked over spheres with a running min to bound the
    [N, chunk, 3] intermediates. A matrix-product expansion of the coefficients (``|o|² - 2o·c + |c|²``) loses about
    |c|²·ε_f32 absolute precision — enough to cause spurious grazing
    self-hits — so no ``dot`` may enter this math.

    Args:
      origin, direction: ``[N, 3]`` (directions unit — ray.h:9, so a=1).
      centers: ``[S, 3]``; radii: ``[S]`` (radius <= 0 marks padding).
      t_min, t_max: scalars or ``[N]``.

    Returns:
      (t ``[N]`` with FLT_MAX for miss, sphere index ``[N]``).
    """
    n = origin.shape[0]
    s = centers.shape[0]
    chunk = min(s, 512)
    s_pad = ((s + chunk - 1) // chunk) * chunk
    cen = jnp.concatenate(
        [centers, jnp.zeros((s_pad - s, 3), centers.dtype)]).reshape(-1, chunk, 3)
    rad = jnp.concatenate(
        [radii, jnp.zeros((s_pad - s,), radii.dtype)]).reshape(-1, chunk)

    t_min = jnp.asarray(t_min, jnp.float32)
    t_max = jnp.asarray(t_max, jnp.float32)
    tmin_b = t_min[:, None] if t_min.ndim else t_min
    tmax_b = t_max[:, None] if t_max.ndim else t_max

    def step(carry, sph):
        t_best, i_best, base = carry
        cc, rr = sph
        oc = origin[:, None, :] - cc[None, :, :]
        b = dot(oc, direction[:, None, :])
        c = dot(oc, oc) - rr[None, :] * rr[None, :]
        ts = _quadratic_ts(b, c, (rr > 0.0)[None, :], tmin_b, tmax_b)
        j = jnp.argmin(ts, axis=-1)
        tj = jnp.take_along_axis(ts, j[:, None], axis=1)[:, 0]
        better = tj < t_best
        t_best = jnp.where(better, tj, t_best)
        i_best = jnp.where(better, base + j.astype(jnp.int32), i_best)
        return (t_best, i_best, base + chunk), None

    # derive inits from the input so the carry matches the body's sharding
    # varyance under shard_map (axis-agnostic alternative to lax.pvary)
    zf = origin[:, 0] * 0.0
    init = (zf + FLT_MAX, zf.astype(jnp.int32) - 1, jnp.int32(0))
    (t_best, i_best, _), _ = jax.lax.scan(step, init, (cen, rad))
    return t_best, jnp.maximum(i_best, 0)


def sphere_hit_one(origin: jnp.ndarray, direction: jnp.ndarray,
                   center: jnp.ndarray, radius, t_min, t_max) -> jnp.ndarray:
    """Single-sphere test for N rays (the light sphere, kernels.cu:346).
    Returns t ``[N]`` (FLT_MAX = miss)."""
    oc = origin - center
    b = dot(oc, direction)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    valid = disc > 0.0
    t1v = jnp.where(valid & (t1 > t_min) & (t1 < t_max), t1, FLT_MAX)
    t2v = jnp.where(valid & (t2 > t_min) & (t2 < t_max), t2, FLT_MAX)
    return jnp.minimum(t1v, t2v)


def plane_hit(p_point: jnp.ndarray, p_norm: jnp.ndarray,
              origin: jnp.ndarray, direction: jnp.ndarray,
              t_min, t_max) -> jnp.ndarray:
    """Single-sided plane test (intersections.h:43–52). Returns t [N]."""
    denom = dot(p_norm, direction)
    po = p_point - origin
    t = dot(po, p_norm) / denom
    miss = (denom > -1e-6) | (t < t_min) | (t > t_max)
    return jnp.where(miss, FLT_MAX, t)


def bbox_hit_dist(bmin: jnp.ndarray, bmax: jnp.ndarray,
                  origin: jnp.ndarray, inv_dir: jnp.ndarray,
                  t_max) -> jnp.ndarray:
    """Slab test returning the entry distance, FLT_MAX on miss
    (intersections.h:25–41). All args broadcast over leading dims with a
    trailing [..., 3]; ``t_max`` is [...]-shaped or scalar.

    Uses explicit ``where`` (not min/max) to preserve the C NaN-comparison
    semantics for 0·inf lanes.
    """
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    neg = inv_dir < 0.0
    lo = jnp.where(neg, t1, t0)
    hi = jnp.where(neg, t0, t1)
    tmin_acc = jnp.full(origin.shape[:-1], BBOX_T_MIN, dtype=jnp.float32)
    tmax_acc = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), origin.shape[:-1])
    for a in range(3):
        tmin_acc = jnp.where(lo[..., a] > tmin_acc, lo[..., a], tmin_acc)
        tmax_acc = jnp.where(hi[..., a] < tmax_acc, hi[..., a], tmax_acc)
    return jnp.where(tmax_acc < tmin_acc, FLT_MAX, tmin_acc)


def bbox_hit(bmin: jnp.ndarray, bmax: jnp.ndarray,
             origin: jnp.ndarray, inv_dir: jnp.ndarray, t_max) -> jnp.ndarray:
    """Boolean slab test (intersections.h:7–23)."""
    return bbox_hit_dist(bmin, bmax, origin, inv_dir, t_max) < FLT_MAX


def triangles_hit(v0: jnp.ndarray, v1: jnp.ndarray, v2: jnp.ndarray,
                  origin: jnp.ndarray, direction: jnp.ndarray,
                  t_min, t_max) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Möller–Trumbore (intersections.h:54–83), broadcast over any batch.

    ``v0/v1/v2``, ``origin``, ``direction`` must broadcast to a common
    ``[..., 3]``; ``t_min``/``t_max`` broadcast to the batch shape.

    Returns (t, u, v) with t = FLT_MAX on miss. Degenerate / sentinel
    triangles (non-finite or zero-area) report miss, which subsumes the
    reference's inf-sentinel leaf padding check (kernels.cu:202).
    """
    eps = 1e-7  # intersections.h:55
    edge1 = v1 - v0
    edge2 = v2 - v0
    # Restructured MT: one shared cross q = s×d plus the (precomputable)
    # face normal n = e1×e2 replace the reference's two per-pair crosses
    # (h = d×e2, q = s×e1). Determinant identities (exact in the reals):
    #   a = e1·(d×e2) = det[e1,d,e2] = -(d·n)
    #   u·a = s·(d×e2) = det[s,d,e2] = (s×d)·e2
    #   v·a = d·(s×e1) = det[d,s,e1] = -((s×d)·e1)
    #   t·a = e2·(s×e1) = det[e2,s,e1] = det[s,e1,e2] = s·n
    # about 13% fewer per-pair ops.
    nrm = cross(edge1, edge2)
    a = -dot(direction, nrm)
    parallel = jnp.abs(a) < eps
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = origin - v0
    q = cross(s, direction)
    u = f * dot(q, edge2)
    v = -(f * dot(q, edge1))
    t = f * dot(s, nrm)
    bad = (parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
           | ~(t > t_min) | ~(t < t_max) | ~jnp.isfinite(t))
    return jnp.where(bad, FLT_MAX, t), u, v
