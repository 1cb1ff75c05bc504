"""Component-SoA 3-vectors: three ``[N]`` arrays instead of one ``[N, 3]``.

Interleaved ``[N, 3]`` state makes every elementwise op stride over a
3-wide minor axis; the reference applies the same fix to its CUDA AoS
data (SoA batches, SURVEY §2): store x/y/z as separate dense ``[N]``
arrays. Whether the layout still pays on the GPU is not measured. :class:`V3` is a NamedTuple pytree with full operator support, so
vector code reads like vec3.h while compiling to dense lane-parallel ops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class V3(NamedTuple):
    """Batched 3-vector in component-SoA form (each field ``[...]``)."""
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic -------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__
    __radd__ = __add__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return self * (1.0 / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- geometry ---------------------------------------------------------
    def dot(self, o: "V3") -> jnp.ndarray:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(self.y * o.z - self.z * o.y,
                  self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def squared_length(self) -> jnp.ndarray:
        return self.dot(self)

    def length(self) -> jnp.ndarray:
        return jnp.sqrt(self.squared_length())

    def normalized(self, eps: float = 1e-20) -> "V3":
        inv = jax.lax.rsqrt(jnp.maximum(self.squared_length(), eps))
        return self * inv

    def max3(self) -> jnp.ndarray:
        """Largest component (russian-roulette survival, kernels.cu:515)."""
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def exp(self) -> "V3":
        return V3(jnp.exp(self.x), jnp.exp(self.y), jnp.exp(self.z))

    # -- conversion -------------------------------------------------------
    def stack(self) -> jnp.ndarray:
        """→ [..., 3] interleaved (host-facing boundaries only)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @staticmethod
    def from_array(a) -> "V3":
        """[..., 3] → V3 (component slices)."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full(shape, vx, vy, vz, dtype=jnp.float32) -> "V3":
        return V3(jnp.full(shape, vx, dtype), jnp.full(shape, vy, dtype),
                  jnp.full(shape, vz, dtype))

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "V3":
        z = jnp.zeros(shape, dtype)
        return V3(z, z, z)

    @staticmethod
    def ones(shape, dtype=jnp.float32) -> "V3":
        o = jnp.ones(shape, dtype)
        return V3(o, o, o)


def where(mask: jnp.ndarray, a: V3, b: V3) -> V3:
    """Lane select; mask is [...]-shaped."""
    return V3(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y),
              jnp.where(mask, a.z, b.z))


def reflect(v: V3, n: V3) -> V3:
    """material.h:23–25."""
    return v - n * (2.0 * v.dot(n))


def refract(uv: V3, n: V3, etai_over_etat: jnp.ndarray) -> V3:
    """material.h:15–21 (parallel-component-only under TIR)."""
    cos_theta = jnp.minimum((-uv).dot(n), 1.0)
    r_par = (uv + n * cos_theta) * etai_over_etat
    sqlen = r_par.squared_length()
    perp = jnp.where(sqlen >= 1.0, 0.0,
                     -jnp.sqrt(jnp.maximum(1.0 - sqlen, 0.0)))
    return r_par + n * perp
