"""SoA scene data model.

Rebuilds the reference's POD structs (helper_structs.h:16–228) as
structure-of-arrays pytrees: the AoS ``triangle``/``bvh_node``/``material``
arrays become column arrays so every per-lane stage is a dense vector op.

Material types extend the reference's dispatched set
(DIFFUSE/METAL/GLASS, helper_structs.h:127–131, scene_materials.h:13–20)
with the additional BSDFs the reference ships but only wires into presets
(coat material.h:62, subsurface material.h:94/:115, checker material.h:39).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# material_type, helper_structs.h:127–131, plus preset-only BSDF families.
DIFFUSE = 0
METAL = 1
GLASS = 2
COAT = 3
SSS_DIELECTRIC = 4
SSS = 5
CHECKER = 6

# objId enum, kernels.cu:40–45 (SPHERE added: analytic scenes are
# first-class here rather than a separate code path).
OBJ_NONE = 0
OBJ_TRIMESH = 1
OBJ_PLANE = 2
OBJ_LIGHT = 3
OBJ_SPHERE = 4

# Sky models. kernels.cu:424 (constant) and the RTiOW gradient the
# reference keeps commented at kernels.cu:419–421 (used by the
# random-spheres workload README.md:5).
SKY_CONST = 0
SKY_GRADIENT = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA material table (helper_structs.h:133–138 extended).

    color doubles as: albedo (DIFFUSE), tint (METAL/GLASS), base color
    (COAT). param: fuzz (METAL), ior (GLASS/COAT/SSS_DIELECTRIC), checker
    frequency (CHECKER). param2: fuzz for COAT/GLASS presets.
    """
    mtype: jnp.ndarray       # [M] int32
    color: jnp.ndarray       # [M,3] f32
    color2: jnp.ndarray      # [M,3] f32 (checker alt color)
    param: jnp.ndarray       # [M] f32
    param2: jnp.ndarray      # [M] f32
    absorption: jnp.ndarray  # [M,3] f32 Beer–Lambert sigma (material.h:77)
    scatter_dist: jnp.ndarray  # [M] f32 SSS mean free path (material.h:97)
    tex_id: jnp.ndarray      # [M] int32, -1 = none

    @property
    def count(self) -> int:
        return self.mtype.shape[0]


def make_materials(rows) -> Materials:
    """rows: list of dicts with keys type, color, and optional color2,
    param, param2, absorption, scatter_dist, tex_id."""
    def col(key, default, width=None):
        out = []
        for r in rows:
            v = r.get(key, default)
            out.append(v)
        a = np.asarray(out, dtype=np.float32 if width else None)
        return a
    m = len(rows)
    return Materials(
        mtype=jnp.asarray([r["type"] for r in rows], jnp.int32),
        color=jnp.asarray(np.reshape(col("color", (0.0, 0.0, 0.0), 3), (m, 3)), jnp.float32),
        color2=jnp.asarray(np.reshape(col("color2", (0.0, 0.0, 0.0), 3), (m, 3)), jnp.float32),
        param=jnp.asarray(np.asarray(col("param", 0.0), np.float32), jnp.float32),
        param2=jnp.asarray(np.asarray(col("param2", 0.0), np.float32), jnp.float32),
        absorption=jnp.asarray(np.reshape(col("absorption", (0.0, 0.0, 0.0), 3), (m, 3)), jnp.float32),
        scatter_dist=jnp.asarray(np.asarray(col("scatter_dist", 1.0), np.float32), jnp.float32),
        tex_id=jnp.asarray([int(r.get("tex_id", -1)) for r in rows], jnp.int32),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeshData:
    """Triangle mesh + implicit-heap BVH, SoA.

    The BVH layout matches the reference's invariants (kernels.cu:614,
    :199–203): a complete binary tree indexed from 1, ``first_leaf =
    num_nodes // 2``, leaf ``i`` covering triangles
    ``[(i - first_leaf) * prims_per_leaf, +prims_per_leaf)`` with padding
    (here: non-finite sentinel triangles that never hit).
    """
    v0: jnp.ndarray        # [T,3]
    v1: jnp.ndarray        # [T,3]
    v2: jnp.ndarray        # [T,3]
    tex_coords: jnp.ndarray  # [T,6] (t0u,t0v,t1u,t1v,t2u,t2v)
    mesh_id: jnp.ndarray   # [T] int32 — material index (helper_structs.h:95)
    bvh_min: jnp.ndarray   # [Nn,3]
    bvh_max: jnp.ndarray   # [Nn,3]
    bounds_min: jnp.ndarray  # [3]
    bounds_max: jnp.ndarray  # [3]
    first_leaf: int = dataclasses.field(metadata=dict(static=True))
    prims_per_leaf: int = dataclasses.field(metadata=dict(static=True))

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Unified scene: optional sphere set, optional mesh, optional floor
    plane, sphere light, sky (kernel_scene + RenderContext fields,
    helper_structs.h:217–228, kernels.cu:69–101)."""
    materials: Materials
    # analytic spheres (None for mesh-only scenes)
    sphere_center: Optional[jnp.ndarray]  # [S,3]
    sphere_radius: Optional[jnp.ndarray]  # [S]
    sphere_mat: Optional[jnp.ndarray]     # [S] int32
    # triangle mesh
    mesh: Optional[MeshData]
    # floor plane (helper_structs.h:160–166; disabled in the as-built
    # reference, kernels.cu:341–345)
    plane_point: Optional[jnp.ndarray]  # [3]
    plane_norm: Optional[jnp.ndarray]   # [3]
    plane_mat: Optional[jnp.ndarray]    # [] int32
    # sphere light (kernels.cu:93–94)
    light_center: jnp.ndarray  # [3]
    light_radius: jnp.ndarray  # []
    light_color: jnp.ndarray   # [3]
    # sky
    sky_color: jnp.ndarray     # [3] (const mode)
    # textures: padded atlas stack [K,Hmax,Wmax,3] + true sizes
    tex_atlas: Optional[jnp.ndarray]   # [K,H,W,3]
    tex_width: Optional[jnp.ndarray]   # [K] int32
    tex_height: Optional[jnp.ndarray]  # [K] int32
    # static config
    use_nee: bool = dataclasses.field(metadata=dict(static=True))
    sky_mode: int = dataclasses.field(metadata=dict(static=True))

    @property
    def has_spheres(self) -> bool:
        return self.sphere_center is not None

    @property
    def has_mesh(self) -> bool:
        return self.mesh is not None

    @property
    def has_plane(self) -> bool:
        return self.plane_point is not None

    @property
    def has_textures(self) -> bool:
        return self.tex_atlas is not None


def make_scene(materials: Materials,
               sphere_center=None, sphere_radius=None, sphere_mat=None,
               mesh: Optional[MeshData] = None,
               plane_point=None, plane_norm=None, plane_mat=None,
               light_center=(52.514355, 715.686951, -272.620972),
               light_radius=50.0,
               light_color=(20.0, 20.0, 20.0),
               sky_color=(0.5, 0.5, 0.5),
               tex_atlas=None, tex_width=None, tex_height=None,
               use_nee=True, sky_mode=SKY_CONST) -> Scene:
    """Scene factory. Light defaults are the reference's hardcoded sphere
    light (kernels.cu:93–94); sky default is the constant 0.5 sky
    (kernels.cu:424)."""
    f32 = lambda x: None if x is None else jnp.asarray(x, jnp.float32)
    i32 = lambda x: None if x is None else jnp.asarray(x, jnp.int32)
    return Scene(
        materials=materials,
        sphere_center=f32(sphere_center),
        sphere_radius=f32(sphere_radius),
        sphere_mat=i32(sphere_mat),
        mesh=mesh,
        plane_point=f32(plane_point),
        plane_norm=f32(plane_norm),
        plane_mat=i32(plane_mat),
        light_center=jnp.asarray(light_center, jnp.float32),
        light_radius=jnp.asarray(light_radius, jnp.float32),
        light_color=jnp.asarray(light_color, jnp.float32),
        sky_color=jnp.asarray(sky_color, jnp.float32),
        tex_atlas=f32(tex_atlas),
        tex_width=i32(tex_width),
        tex_height=i32(tex_height),
        use_nee=bool(use_nee),
        sky_mode=int(sky_mode),
    )


def sky_radiance(scene: Scene, direction: jnp.ndarray) -> jnp.ndarray:
    """Environment radiance for escaped rays [N,3].

    SKY_CONST: kernels.cu:424. SKY_GRADIENT: the RTiOW gradient
    (kernels.cu:419–421, used by the random-spheres workload).
    """
    if scene.sky_mode == SKY_GRADIENT:
        t = 0.5 * (direction[..., 1] + 1.0)
        white = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)
        blue = jnp.asarray([0.5, 0.7, 1.0], jnp.float32)
        return (1.0 - t)[..., None] * white + t[..., None] * blue
    return jnp.broadcast_to(scene.sky_color, direction.shape)


def hex_color(hex_value: int) -> tuple:
    """scene_materials.h:6–11."""
    r = ((hex_value >> 16) & 0xFF) / 255.0
    g = ((hex_value >> 8) & 0xFF) / 255.0
    b = (hex_value & 0xFF) / 255.0
    return (r, g, b)
