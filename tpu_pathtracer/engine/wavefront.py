"""Wavefront path-tracing stages (component-SoA) + the plain batch engine.

The reference renders with one megakernel: one CUDA thread owns one pixel
and serially loops samples × bounces (kernels.cu:535–569, :396–533). This
engine is a *wavefront* instead: a batch of N paths advances one bounce
per iteration of a ``lax.while_loop``; each stage (intersect, scatter,
NEE, roulette) is a fixed-shape masked vector op over dense ``[N]``
component arrays (:mod:`tpu_pathtracer.ops.v3`). Whether the bounce loop
should be fused back into one kernel on the GPU is an open question.

Radiance accumulation reproduces the reference exactly (SURVEY §3.3):
  * miss  → ``color += attenuation * sky`` then the path ends
    (kernels.cu:424);
  * specular light hit → path ends contributing NOTHING when NEE is on
    (the as-built quirk, kernels.cu:440–446), or adds
    ``attenuation * lightColor`` when NEE is off (kernels.cu:444);
  * NEE contribution uses the attenuation *after* the scatter update
    (kernels.cu:487 before :493);
  * roulette starts at bounce 4 with survival prob max(attenuation)
    (kernels.cu:512–527).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.camera import Camera
from tpu_pathtracer.models import scene as sc
from tpu_pathtracer.models.scene import Scene
from tpu_pathtracer.ops import bvh as _bvh
from tpu_pathtracer.ops import materials as _m
from tpu_pathtracer.ops import rng as _rng
from tpu_pathtracer.ops.intersect import spheres_hit
from tpu_pathtracer.ops.v3 import V3, where as vwhere
from tpu_pathtracer.ops.vec import FLT_MAX


class MatCols(NamedTuple):
    """Per-lane material columns (the `material` row each lane hit,
    helper_structs.h:133–138 extended), gathered by material id."""
    mtype: jnp.ndarray        # [N] int32
    color: V3
    color2: V3
    param: jnp.ndarray
    param2: jnp.ndarray
    absorption: V3
    scatter_dist: jnp.ndarray
    tex_id: jnp.ndarray       # [N] int32

    @staticmethod
    def zeros(n: int) -> "MatCols":
        z = jnp.zeros((n,))
        zi = jnp.zeros((n,), jnp.int32)
        return MatCols(zi, V3.zeros((n,)), V3.zeros((n,)), z, z,
                       V3.zeros((n,)), z, zi)


def _cols_where(mask: jnp.ndarray, a: MatCols, b: MatCols) -> MatCols:
    return jax.tree.map(lambda x, y: jnp.where(mask, x, y), a, b)


def _gather_cols(mats, mat_id: jnp.ndarray) -> MatCols:
    """Material columns via jnp gathers."""
    g = lambda a: a[mat_id]
    g3 = lambda a: V3(a[:, 0][mat_id], a[:, 1][mat_id], a[:, 2][mat_id])
    return MatCols(mtype=g(mats.mtype), color=g3(mats.color),
                   color2=g3(mats.color2), param=g(mats.param),
                   param2=g(mats.param2), absorption=g3(mats.absorption),
                   scatter_dist=g(mats.scatter_dist), tex_id=g(mats.tex_id))


class SceneView(NamedTuple):
    """Per-call component-SoA view of the scene's hot arrays. Built once
    per traced function (outside the bounce loop) so the slices are loop
    invariants."""
    sph_c: Optional[V3]            # sphere centers, [S] components
    sph_r: Optional[jnp.ndarray]   # [S]
    tri_e1: Optional[V3]           # [T] edge components
    tri_e2: Optional[V3]
    atlas: Optional[jnp.ndarray]     # [K*H*W, 3] row-packed texel table


def make_view(scene: Scene) -> SceneView:
    sph_c = sph_r = None
    if scene.has_spheres:
        sph_c = V3.from_array(scene.sphere_center)
        sph_r = scene.sphere_radius
    tri_e1 = tri_e2 = None
    if scene.has_mesh:
        m = scene.mesh
        tri_v0 = V3.from_array(m.v0)
        tri_e1 = V3.from_array(m.v1) - tri_v0
        tri_e2 = V3.from_array(m.v2) - tri_v0
    atlas = None
    if scene.has_textures:
        # [K,H,W,3] -> [K*H*W, 3]: the texel fetch becomes one row
        # gather per lane instead of three element gathers
        atlas = scene.tex_atlas.reshape(-1, 3)
    return SceneView(sph_c, sph_r, tri_e1, tri_e2, atlas)


class Intersection(NamedTuple):
    """SoA `intersection` (helper_structs.h:16–36) + the hit material's
    columns."""
    obj: jnp.ndarray      # [N] int32 OBJ_* id
    t: jnp.ndarray        # [N]
    normal: V3            # flipped to face the ray (kernels.cu:354)
    cols: "MatCols"       # material of the hit surface
    tex_u: jnp.ndarray    # [N]
    tex_v: jnp.ndarray    # [N]


class Stats(NamedTuple):
    """The reference's full 18-counter ray-accounting matrix
    (kernels.cu:48–66) as masked sums. Semantics follow the as-built
    rayStat call sites exactly, including the quirk that a primary ray
    hitting a non-mesh surface ALSO counts into primary_nohit
    (kernels.cu:430). nodes_both/nodes_single (kernels.cu:220–221) count
    per-ray traversal steps; the brute-force path visits no nodes."""
    primary: jnp.ndarray
    primary_hit_mesh: jnp.ndarray
    primary_nohit: jnp.ndarray
    primary_bbox_nohit: jnp.ndarray
    secondary: jnp.ndarray
    secondary_mesh: jnp.ndarray
    secondary_nohit: jnp.ndarray
    secondary_mesh_nohit: jnp.ndarray
    secondary_bbox_nohit: jnp.ndarray
    shadows: jnp.ndarray
    shadows_bbox_nohit: jnp.ndarray
    shadows_nohit: jnp.ndarray
    low_power: jnp.ndarray
    exceed_max_bounce: jnp.ndarray
    roulette_kill: jnp.ndarray
    nans: jnp.ndarray
    nodes_both: jnp.ndarray
    nodes_single: jnp.ndarray

    @staticmethod
    def zeros() -> "Stats":
        z = jnp.zeros((), jnp.int32)
        return Stats(*([z] * len(Stats._fields)))


# ---------------------------------------------------------------------------
# intersection
# ---------------------------------------------------------------------------


def _spheres_nearest(view: SceneView, origin: V3, direction: V3,
                     t_min: float, t_max):
    """Nearest hit over the sphere set (t, sphere index); t is FLT_MAX on
    a miss. A Pallas kernel for this ran slower than what XLA makes of
    the chunked jnp scan on the H100 (PERF.md)."""
    return spheres_hit(origin.stack(), direction.stack(), view.sph_c.stack(),
                       view.sph_r, t_min, t_max)


def _mesh_nearest(scene: Scene, config: RenderConfig, origin: V3,
                  direction: V3, t_min: float, t_max,
                  is_shadow: bool = False):
    """Mesh intersection: per-ray BVH traversal, or the all-triangles
    oracle path when use_bvh is off (kernels.cu:307–321)."""
    o = origin.stack()
    d = direction.stack()
    if config.use_bvh:
        return _bvh.traverse(scene.mesh, o, d, t_min, t_max,
                             is_shadow=is_shadow)
    return _bvh.brute_force(scene.mesh, o, d, t_min, t_max)


def _mesh_bbox_hit(scene: Scene, origin: V3, direction: V3,
                   t_max) -> jnp.ndarray:
    """Global mesh-bbox slab test (hit_bbox at hitMesh, kernels.cu:298) —
    used for the *_bbox_nohit stats counters only: the traversal rejects
    at the root node anyway.

    A component-SoA re-expression of ``ops.intersect.bbox_hit`` (which
    takes interleaved [..., 3] arrays), with the same where-form slab
    semantics; keep the two in sync."""
    from tpu_pathtracer.ops.intersect import BBOX_T_MIN

    bmin = scene.mesh.bounds_min
    bmax = scene.mesh.bounds_max
    tmin_acc = jnp.full(origin.x.shape, BBOX_T_MIN, jnp.float32)
    tmax_acc = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                                origin.x.shape)
    for o, d, a in ((origin.x, direction.x, 0), (origin.y, direction.y, 1),
                    (origin.z, direction.z, 2)):
        inv = 1.0 / d
        t0 = (bmin[a] - o) * inv
        t1 = (bmax[a] - o) * inv
        neg = inv < 0.0
        lo = jnp.where(neg, t1, t0)
        hi = jnp.where(neg, t0, t1)
        tmin_acc = jnp.where(lo > tmin_acc, lo, tmin_acc)
        tmax_acc = jnp.where(hi < tmax_acc, hi, tmax_acc)
    return tmax_acc >= tmin_acc


def _sphere_hit_one(origin: V3, direction: V3, center, radius,
                    t_min, t_max) -> jnp.ndarray:
    """Single-sphere test (the light, kernels.cu:346)."""
    oc = origin - V3(center[0], center[1], center[2])
    b = oc.dot(direction)
    c = oc.dot(oc) - radius * radius
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    ok = disc > 0.0
    t1v = jnp.where(ok & (t1 > t_min) & (t1 < t_max), t1, FLT_MAX)
    t2v = jnp.where(ok & (t2 > t_min) & (t2 < t_max), t2, FLT_MAX)
    return jnp.minimum(t1v, t2v)


def _plane_hit(scene: Scene, origin: V3, direction: V3, t_min,
               t_max) -> jnp.ndarray:
    """Single-sided plane (intersections.h:43–52)."""
    nrm = scene.plane_norm
    pt = scene.plane_point
    denom = (direction.x * nrm[0] + direction.y * nrm[1]
             + direction.z * nrm[2])
    po_dot_n = ((pt[0] - origin.x) * nrm[0] + (pt[1] - origin.y) * nrm[1]
                + (pt[2] - origin.z) * nrm[2])
    t = po_dot_n / denom
    miss = (denom > -1e-6) | (t < t_min) | (t > t_max)
    return jnp.where(miss, FLT_MAX, t)


def intersect_scene(scene: Scene, view: SceneView, config: RenderConfig,
                    origin: V3, direction: V3, specular: jnp.ndarray,
                    alive: Optional[jnp.ndarray] = None):
    """Top-level `hit()` (kernels.cu:325–360) over a ray batch.

    Surface geometry (mesh / spheres / plane) competes by nearest t; the
    light sphere is only tested for specular lanes and only when no
    surface was hit (the reference's else-branch ordering,
    kernels.cu:339–349).

    Returns (Intersection, (nodes_both, nodes_single)) — the scalar BVH
    step telemetry feeding NUM_NODES_BOTH/SINGLE (kernels.cu:220–221);
    zeros on the non-traversal paths.
    """
    n = origin.x.shape[0]
    eps = config.epsilon
    t = jnp.full((n,), FLT_MAX)
    obj = jnp.full((n,), sc.OBJ_NONE, jnp.int32)
    normal = V3.zeros((n,))
    cols = MatCols.zeros(n)
    tex_u = jnp.zeros((n,))
    tex_v = jnp.zeros((n,))
    node_counts = (jnp.int32(0), jnp.int32(0))
    # Analytic geometry first (spheres + plane are O(1) per lane), so
    # their best t SEEDS the expensive mesh traversal: the kernels'
    # strictly-closer tests then cull every node/leaf beyond the floor
    # or a sphere from step one. The final winner is unchanged (the mesh
    # only ever wins strictly-closer hits); only exact-t ties between a
    # triangle and an analytic surface would flip, and no scene has
    # coincident geometry (zoo floors are plane-only).
    if scene.has_spheres:
        st, sidx = _spheres_nearest(view, origin, direction, eps, FLT_MAX)
        center = V3(view.sph_c.x[sidx], view.sph_c.y[sidx],
                    view.sph_c.z[sidx])
        radius = view.sph_r[sidx]
        scols = _gather_cols(scene.materials, scene.sphere_mat[sidx])
        win = st < t
        p = origin + direction * st
        nrm = (p - center) * (1.0 / jnp.maximum(radius, 1e-30))
        t = jnp.where(win, st, t)
        obj = jnp.where(win, sc.OBJ_SPHERE, obj)
        normal = vwhere(win, nrm, normal)
        cols = _cols_where(win, scols, cols)

    if scene.has_plane:
        pt = _plane_hit(scene, origin, direction, eps, FLT_MAX)
        win = pt < t
        nrm = scene.plane_norm
        t = jnp.where(win, pt, t)
        obj = jnp.where(win, sc.OBJ_PLANE, obj)
        normal = vwhere(win, V3.full((n,), nrm[0], nrm[1], nrm[2]), normal)
        pcols = _gather_cols(scene.materials,
                             jnp.broadcast_to(scene.plane_mat, (n,)))
        cols = _cols_where(win, pcols, cols)

    # dead lanes trace with t_max = -1: instantly inert on every mesh
    # path (no traversal work, no node-count pollution); their outputs
    # are masked downstream anyway
    t_ray_max = (t if alive is None
                 else jnp.where(alive, t, -1.0))

    if scene.has_mesh:
        mesh = scene.mesh
        res = _mesh_nearest(scene, config, origin, direction, eps,
                            t_ray_max)
        node_counts = (res.nodes_both, res.nodes_single)
        hit = res.tri_id >= 0
        tri = jnp.maximum(res.tri_id, 0)
        e1 = V3(view.tri_e1.x[tri], view.tri_e1.y[tri], view.tri_e1.z[tri])
        e2 = V3(view.tri_e2.x[tri], view.tri_e2.y[tri], view.tri_e2.z[tri])
        tc = mesh.tex_coords
        u, vv = res.u, res.v
        w0 = 1.0 - u - vv
        # barycentric texcoord interpolation, kernels.cu:337–338
        tu = u * tc[:, 2][tri] + vv * tc[:, 4][tri] + w0 * tc[:, 0][tri]
        tv = u * tc[:, 3][tri] + vv * tc[:, 5][tri] + w0 * tc[:, 1][tri]
        mcols = _gather_cols(scene.materials,
                             jnp.clip(mesh.mesh_id[tri], 0,
                                      scene.materials.count - 1))
        nrm = e1.cross(e2).normalized()  # kernels.cu:336
        res_t = res.t
        win = hit & (res_t < t)
        t = jnp.where(win, res_t, t)
        obj = jnp.where(win, sc.OBJ_TRIMESH, obj)
        normal = vwhere(win, nrm, normal)
        cols = _cols_where(win, mcols, cols)
        tex_u = jnp.where(win, tu, tex_u)
        tex_v = jnp.where(win, tv, tex_v)

    if scene.use_nee:
        # light sphere only for specular rays with no surface hit
        # (kernels.cu:346–349)
        lt = _sphere_hit_one(origin, direction, scene.light_center,
                             scene.light_radius, eps, FLT_MAX)
        win = specular & (obj == sc.OBJ_NONE) & (lt < FLT_MAX)
        t = jnp.where(win, lt, t)
        obj = jnp.where(win, sc.OBJ_LIGHT, obj)

    # flip normal to face the ray (kernels.cu:354–355)
    flip = direction.dot(normal) > 0.0
    normal = vwhere(flip, -normal, normal)
    return Intersection(obj=obj, t=t, normal=normal, cols=cols,
                        tex_u=tex_u, tex_v=tex_v), node_counts


def occluded(scene: Scene, view: SceneView, config: RenderConfig,
             origin: V3, direction: V3, t_max: jnp.ndarray) -> jnp.ndarray:
    """Shadow-ray occlusion (any-hit). The reference occludes only against
    the triangle mesh (kernels.cu:340); analytic scenes use their spheres
    as the occluder set. Returns (occluded, (nodes_both, nodes_single))."""
    n = origin.x.shape[0]
    occ = jnp.zeros((n,), bool)
    node_counts = (jnp.int32(0), jnp.int32(0))
    if scene.has_mesh:
        res = _mesh_nearest(scene, config, origin, direction,
                            config.epsilon, t_max, is_shadow=True)
        node_counts = (res.nodes_both, res.nodes_single)
        occ = occ | (res.tri_id >= 0)
    if scene.has_spheres:
        st, _ = _spheres_nearest(view, origin, direction, config.epsilon,
                                 t_max)
        occ = occ | (st < t_max)
    return occ, node_counts


def sky_radiance(scene: Scene, direction: V3) -> V3:
    """kernels.cu:424 (constant) / kernels.cu:419–421 (RTiOW gradient)."""
    n = direction.x.shape[0]
    if scene.sky_mode == sc.SKY_GRADIENT:
        t = 0.5 * (direction.y + 1.0)
        return V3(1.0 - 0.5 * t, 1.0 - 0.3 * t, jnp.ones_like(t))
    c = scene.sky_color
    return V3.full((n,), c[0], c[1], c[2])


def resolve_albedo(scene: Scene, view: SceneView, config: RenderConfig,
                   cols: MatCols, tex_u: jnp.ndarray,
                   tex_v: jnp.ndarray, use_tex: jnp.ndarray) -> V3:
    """Texture-or-color albedo (kernels.cu:456–476): nearest-neighbor
    wrap-mode lookup as a single row gather from the flat texel table
    (one ~1.3 ms gather for all three channels instead of three)."""
    base = cols.color
    if not (scene.has_textures and config.textures):
        return base
    tid = cols.tex_id
    tid_c = jnp.maximum(tid, 0)
    w = scene.tex_width[tid_c]
    h = scene.tex_height[tid_c]
    fu = tex_u - jnp.floor(tex_u)
    fv = tex_v - jnp.floor(tex_v)
    tx = ((w - 1).astype(jnp.float32) * fu).astype(jnp.int32)
    ty = ((h - 1).astype(jnp.float32) * fv).astype(jnp.int32)
    hmax = scene.tex_atlas.shape[1]
    wmax = scene.tex_atlas.shape[2]
    flat = (tid_c * hmax + ty) * wmax + tx
    texel_rows = view.atlas[flat]  # [N, 3] — one gather
    texel = V3(texel_rows[:, 0], texel_rows[:, 1], texel_rows[:, 2])
    return vwhere(use_tex & (tid >= 0), texel, base)


def generate_shadow_rays(scene: Scene, origin: V3, normal: V3,
                         attenuation: V3, eps1: jnp.ndarray,
                         eps2: jnp.ndarray):
    """Solid-angle sphere-light sampling (generateShadowRay,
    kernels.cu:363–393). Returns (valid, shadow_dir, contribution,
    light_dist)."""
    lc = scene.light_center
    to_light = V3(lc[0] - origin.x, lc[1] - origin.y, lc[2] - origin.z)
    sw = to_light.normalized()
    big_x = jnp.abs(sw.x) > 0.01
    up = V3(jnp.where(big_x, 0.0, 1.0), jnp.where(big_x, 1.0, 0.0),
            jnp.zeros_like(sw.x))
    su = up.cross(sw).normalized()
    sv = sw.cross(su)

    d2 = to_light.squared_length()
    ratio = 1.0 - scene.light_radius * scene.light_radius / d2
    valid = ratio >= 0.0  # isnan(cosAMax) guard, kernels.cu:372
    cos_a_max = jnp.sqrt(jnp.maximum(ratio, 0.0))
    cos_a = 1.0 - eps1 + eps1 * cos_a_max
    sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
    phi = 2.0 * jnp.pi * eps2
    l = (su * (jnp.cos(phi) * sin_a) + sv * (jnp.sin(phi) * sin_a)
         + sw * cos_a)
    dotl = l.dot(normal)
    valid = valid & (dotl > 0.0)
    shadow_dir = l.normalized()
    omega = 2.0 * jnp.pi * (1.0 - cos_a_max)
    scale = dotl * omega / jnp.pi
    lcol = scene.light_color
    contribution = attenuation * V3(lcol[0] * scale, lcol[1] * scale,
                                    lcol[2] * scale)
    light_dist = jnp.sqrt(d2) - scene.light_radius  # kernels.cu:390
    return valid, shadow_dir, contribution, light_dist


class BounceState(NamedTuple):
    """Mutable per-lane path state threaded through one bounce."""
    origin: V3
    direction: V3
    color: V3
    attenuation: V3
    specular: jnp.ndarray
    inside: jnp.ndarray
    alive: jnp.ndarray
    # previous bounce hit the triangle mesh (STATS `fromMesh`,
    # kernels.cu:400/:430) — only consumed by the stats counters
    from_mesh: jnp.ndarray


def bounce_step(scene: Scene, view: SceneView, config: RenderConfig,
                state: BounceState, pixel: jnp.ndarray, sample: jnp.ndarray,
                bounce: jnp.ndarray, stats: Optional[Stats] = None
                ) -> Tuple[BounceState, Optional[Stats]]:
    """One wavefront bounce for all lanes — the body of `color()`
    (kernels.cu:402–527). ``bounce`` may be scalar (plain engine) or
    per-lane [N] (regeneration engine)."""
    base = _rng.bounce_base(pixel, sample, bounce)
    alive = state.alive

    def count(stat, mask):
        return stat + jnp.sum(mask, dtype=jnp.int32)

    inters, node_counts = intersect_scene(scene, view, config, state.origin,
                                          state.direction, state.specular,
                                          alive=alive)
    if stats is not None:
        # per-bounce counters, kernels.cu:404-407
        primary_m = alive & (bounce == 0)
        secondary_m = alive & (bounce > 0)
        low = alive & (state.attenuation.squared_length() < 1e-4)
        stats = stats._replace(
            primary=count(stats.primary, primary_m),
            secondary=count(stats.secondary, secondary_m),
            secondary_mesh=count(stats.secondary_mesh,
                                 alive & state.from_mesh),
            low_power=count(stats.low_power, low),
            nodes_both=stats.nodes_both + node_counts[0],
            nodes_single=stats.nodes_single + node_counts[1])
        if scene.has_mesh:
            # global mesh-bbox reject accounting (hitMesh,
            # kernels.cu:298-300)
            bbhit = _mesh_bbox_hit(scene, state.origin, state.direction,
                                   FLT_MAX)
            stats = stats._replace(
                primary_bbox_nohit=count(stats.primary_bbox_nohit,
                                         primary_m & ~bbhit),
                secondary_bbox_nohit=count(stats.secondary_bbox_nohit,
                                           secondary_m & ~bbhit))

    # ---- miss → sky (kernels.cu:424)
    miss = alive & (inters.obj == sc.OBJ_NONE)
    color = state.color + vwhere(
        miss, state.attenuation * sky_radiance(scene, state.direction),
        V3.zeros(miss.shape))
    is_mesh_hit = inters.obj == sc.OBJ_TRIMESH
    if stats is not None:
        hit_any = alive & ~miss
        stats = stats._replace(
            # the quirk at kernels.cu:430: a primary ray hitting a
            # non-mesh surface also counts as primary_nohit
            primary_nohit=count(
                stats.primary_nohit,
                (bounce == 0) & (miss | (hit_any & ~is_mesh_hit))),
            primary_hit_mesh=count(stats.primary_hit_mesh,
                                   (bounce == 0) & hit_any & is_mesh_hit),
            secondary_nohit=count(stats.secondary_nohit,
                                  miss & (bounce > 0) & ~state.from_mesh),
            secondary_mesh_nohit=count(
                stats.secondary_mesh_nohit,
                miss & (bounce > 0) & state.from_mesh))

    # ---- light hit by specular path (kernels.cu:433–447)
    light_hit = alive & (inters.obj == sc.OBJ_LIGHT)
    if not config.shadow:
        lc = scene.light_color
        color = color + vwhere(
            light_hit, state.attenuation * V3.full(miss.shape, lc[0], lc[1], lc[2]),
            V3.zeros(miss.shape))

    surf = alive & ~miss & ~light_hit
    alive = surf

    # ---- scatter (kernels.cu:452–489)
    cols = inters.cols
    albedo = resolve_albedo(scene, view, config, cols, inters.tex_u,
                            inters.tex_v, inters.obj == sc.OBJ_TRIMESH)
    hit_p = state.origin + state.direction * inters.t
    out = _m.scatter(
        wo=state.direction, normal=inters.normal, hit_t=inters.t,
        hit_p=hit_p, inside=state.inside,
        mtype=cols.mtype, albedo=albedo, color2=cols.color2,
        param=cols.param, param2=cols.param2, absorption=cols.absorption,
        scatter_dist=cols.scatter_dist, rng_base=base)

    new_origin = vwhere(surf, state.origin + state.direction * out.t,
                        state.origin)
    # NOTE: the reference stores possibly non-unit SSS directions and
    # re-normalizes in the next ray ctor (ray.h:9) but then advances the
    # origin with the non-unit vector (kernels.cu:485) — a scale
    # inconsistency on SSS paths. We normalize at store time instead.
    new_dir = vwhere(surf, out.wi.normalized(), state.direction)
    new_att = vwhere(surf, state.attenuation * out.throughput,
                     state.attenuation)
    new_specular = jnp.where(surf, out.specular, state.specular)
    new_inside = jnp.where(surf, state.inside ^ out.refracted, state.inside)

    # ---- NEE shadow pass (kernels.cu:491–510)
    if config.shadow and scene.use_nee:
        nee_mask = surf & ~new_specular
        valid, sdir, contrib, ldist = generate_shadow_rays(
            scene, new_origin, inters.normal, new_att,
            _rng.slot_uniform(base, _rng.S_NEE0),
            _rng.slot_uniform(base, _rng.S_NEE1))
        nee_mask = nee_mask & valid
        # non-NEE lanes get t_max = -1: every occluder test fails and
        # the traversal retires them at the root
        occ, sh_counts = occluded(scene, view, config, new_origin, sdir,
                                  jnp.where(nee_mask, ldist, -1.0))
        lit = nee_mask & ~occ
        color = color + vwhere(lit, contrib, V3.zeros(miss.shape))
        if stats is not None:
            stats = stats._replace(
                shadows=count(stats.shadows, nee_mask),
                shadows_nohit=count(stats.shadows_nohit, lit),
                nodes_both=stats.nodes_both + sh_counts[0],
                nodes_single=stats.nodes_single + sh_counts[1])
            if scene.has_mesh:
                sbb = _mesh_bbox_hit(scene, new_origin, sdir, ldist)
                stats = stats._replace(
                    shadows_bbox_nohit=count(stats.shadows_bbox_nohit,
                                             nee_mask & ~sbb))

    # ---- Russian roulette (kernels.cu:512–527)
    if config.russian_roulette:
        rr = alive & (bounce > config.rr_start_bounce)
        mx = new_att.max3()
        kill = rr & (_rng.slot_uniform(base, _rng.S_ROULETTE) > mx)
        alive = alive & ~kill
        scale = jnp.where(rr & ~kill, 1.0 / jnp.maximum(mx, 1e-30), 1.0)
        new_att = new_att * scale
        if stats is not None:
            stats = stats._replace(roulette_kill=count(stats.roulette_kill,
                                                       kill))

    # fromMesh for the next bounce (kernels.cu:430): only surf lanes
    # continue, so non-surf lanes' value is never consumed
    new_from_mesh = surf & is_mesh_hit
    return BounceState(origin=new_origin, direction=new_dir, color=color,
                       attenuation=new_att, specular=new_specular,
                       inside=new_inside, alive=alive,
                       from_mesh=new_from_mesh), stats


def trace(scene: Scene, camera: Camera, config: RenderConfig,
          pixel_id: jnp.ndarray, sample: jnp.ndarray,
          valid: Optional[jnp.ndarray] = None
          ) -> Tuple[jnp.ndarray, Stats]:
    """Trace one sample for each pixel lane; returns ([N,3] radiance,
    Stats). This is `color()` (kernels.cu:396–533) as a wavefront loop.

    ``valid`` (optional [N] bool) marks real lanes; tail-padding duplicate
    lanes start dead so they never inflate the Stats counters."""
    n = pixel_id.shape[0]
    view = make_view(scene)
    origin, direction = camera.generate_rays(pixel_id, sample,
                                             config.nx, config.ny)
    # inits derived from inputs: carry varyance matches under shard_map
    zf = pixel_id.astype(jnp.float32) * 0.0
    zb = zf != 0.0
    state = BounceState(
        origin=origin, direction=direction,
        color=V3(zf, zf, zf), attenuation=V3(zf + 1, zf + 1, zf + 1),
        specular=zb, inside=zb,
        alive=~zb if valid is None else valid & ~zb,
        from_mesh=zb,
    )

    def cond(carry):
        state, bounce, _ = carry
        return (bounce < config.max_depth) & jnp.any(state.alive)

    def body(carry):
        state, bounce, stats = carry
        state, stats = bounce_step(scene, view, config, state, pixel_id,
                                   sample, bounce,
                                   stats if config.stats else None)
        if stats is None:
            stats = carry[2]
        return state, bounce + 1, stats

    zstat = jnp.sum(zf).astype(jnp.int32)  # varying scalar zero
    carry = (state, jnp.int32(0), jax.tree.map(lambda s: s + zstat,
                                               Stats.zeros()))
    state, bounce, stats = jax.lax.while_loop(cond, body, carry)
    if config.stats:
        stats = stats._replace(
            exceed_max_bounce=stats.exceed_max_bounce
            + jnp.sum(state.alive, dtype=jnp.int32))
    if config.check_nans:
        isnan = (jnp.isnan(state.color.x) | jnp.isnan(state.color.y)
                 | jnp.isnan(state.color.z))
        stats = stats._replace(nans=stats.nans
                               + jnp.sum(isnan, dtype=jnp.int32))
    return state.color.stack(), stats
