"""BSDF semantics (material.h:27–143 parity)."""

import jax.numpy as jnp
import numpy as np

from tpu_pathtracer.models import scene as sc
from tpu_pathtracer.ops import materials as M
from tpu_pathtracer.ops import rng as R
from tpu_pathtracer.ops.v3 import V3, refract
from tpu_pathtracer.ops.materials import schlick


class _Out:
    """Adapter presenting V3 ScatterOut fields as [N,3] arrays."""

    def __init__(self, out):
        self.wi = np.asarray(out.wi.stack())
        self.throughput = np.asarray(out.throughput.stack())
        self.specular = np.asarray(out.specular)
        self.refracted = np.asarray(out.refracted)
        self.t = np.asarray(out.t)


def _scatter(mtype, n=512, inside=False, param=0.0, param2=0.0,
             absorption=(0, 0, 0), scatter_dist=1.0, albedo=(0.6, 0.5, 0.4),
             color2=(1.0, 1.0, 1.0), hit_t=2.0, wo=(0.0, -0.70710678, -0.70710678),
             normal=(0.0, 1.0, 0.0)):
    pid = jnp.arange(n, dtype=jnp.uint32)
    base = R.bounce_base(pid, jnp.uint32(0), jnp.uint32(0))
    us = R.bounce_uniforms(pid, jnp.uint32(0), jnp.uint32(0))
    ones = jnp.ones((n,))
    v3c = lambda c: V3.full((n,), c[0], c[1], c[2])
    out = M.scatter(
        wo=v3c(wo), normal=v3c(normal),
        hit_t=ones * hit_t, hit_p=V3.full((n,), 0.3, 0.3, 0.3),
        inside=jnp.full((n,), inside),
        mtype=jnp.full((n,), mtype, jnp.int32),
        albedo=v3c(albedo), color2=v3c(color2),
        param=ones * param, param2=ones * param2,
        absorption=v3c(absorption),
        scatter_dist=ones * scatter_dist, rng_base=base)
    return _Out(out), us


def test_diffuse():
    out, _ = _scatter(sc.DIFFUSE)
    wi = np.asarray(out.wi)
    np.testing.assert_allclose(np.linalg.norm(wi, axis=-1), 1.0, atol=1e-5)
    # all directions in the normal hemisphere (|perturbation| < 1 = |n|)
    assert np.all(wi[:, 1] > -1e-6)
    np.testing.assert_allclose(np.asarray(out.throughput),
                               np.tile([0.6, 0.5, 0.4], (len(wi), 1)),
                               atol=1e-6)
    assert not np.any(np.asarray(out.specular))
    assert not np.any(np.asarray(out.refracted))


def test_metal_mirror_and_fuzz():
    wo = np.array([0.0, -0.70710678, -0.70710678])
    out, _ = _scatter(sc.METAL, param=0.0)
    want = wo - 2 * np.dot(wo, [0, 1, 0]) * np.array([0, 1, 0])
    want /= np.linalg.norm(want)
    np.testing.assert_allclose(np.asarray(out.wi),
                               np.tile(want, (len(out.wi), 1)), atol=1e-5)
    assert np.all(np.asarray(out.specular))
    # fuzz spreads directions
    out2, _ = _scatter(sc.METAL, param=0.3)
    spread = np.asarray(out2.wi).std(axis=0).max()
    assert spread > 0.05


def test_glass_fresnel_split_and_flags():
    out, us = _scatter(sc.GLASS, param=1.5)
    refl = np.asarray(out.wi)[:, 1] > 0  # reflected rays go up
    refr = np.asarray(out.refracted)
    assert np.all(refl == ~refr)
    assert np.all(np.asarray(out.specular))
    # entering from outside at 45°: schlick fraction ≈ observed split
    eta = 1 / 1.5
    cos = 0.70710678
    frac = float(np.mean(np.asarray(us)[:, R.S_BSDF3]
                         < np.asarray(schlick(jnp.asarray(cos), jnp.asarray(eta)))))
    assert abs(refl.mean() - frac) < 1e-6


def test_glass_tir_from_inside():
    # inside at 45° with ior 1.5: eta*sin = 1.5*0.707 > 1 → always TIR
    out, _ = _scatter(sc.GLASS, param=1.5, inside=True)
    assert not np.any(np.asarray(out.refracted))


def test_glass_beer_lambert():
    a = (0.5, 1.0, 2.0)
    out, _ = _scatter(sc.GLASS, param=1.5, inside=True, absorption=a, hit_t=2.0)
    # TIR branch (see above): throughput = exp(-a*t) * tint(albedo)
    want = np.exp(-np.asarray(a) * 2.0) * np.asarray([0.6, 0.5, 0.4])
    np.testing.assert_allclose(np.asarray(out.throughput),
                               np.tile(want, (len(out.throughput), 1)),
                               rtol=1e-5)


def test_refract_matches_snell():
    uv = V3.full((1,), 0.0, -0.70710678, -0.70710678)
    n = V3.full((1,), 0.0, 1.0, 0.0)
    out = np.asarray(refract(uv, n, jnp.asarray([1.0 / 1.5])).stack())[0]
    # Snell: sin_out = sin_in/1.5
    sin_out = np.linalg.norm(out[[0, 2]])
    np.testing.assert_allclose(sin_out / np.linalg.norm(out),
                               0.70710678 / 1.5, rtol=1e-4)


def test_coat_mixes_diffuse_and_glossy():
    out, _ = _scatter(sc.COAT, param=1.5, color2=(1, 1, 1))
    spec = np.asarray(out.specular)
    assert 0 < spec.mean() < 0.5  # schlick at 45° ≈ 0.05–0.3
    thr = np.asarray(out.throughput)
    np.testing.assert_allclose(thr[spec], np.ones_like(thr[spec]), atol=1e-6)
    np.testing.assert_allclose(thr[~spec],
                               np.tile([0.6, 0.5, 0.4], (int((~spec).sum()), 1)),
                               atol=1e-6)


def test_sss_free_flight():
    out, us = _scatter(sc.SSS, inside=True, scatter_dist=1.0, hit_t=2.0,
                       absorption=(0.1, 0.1, 0.1))
    d_free = -np.log(np.asarray(us)[:, R.S_BSDF4])
    scattered = d_free < 2.0
    refr = np.asarray(out.refracted)
    np.testing.assert_array_equal(refr, ~scattered)
    # non-scattered keep direction
    wo = np.array([0.0, -0.70710678, -0.70710678])
    np.testing.assert_allclose(np.asarray(out.wi)[~scattered],
                               np.tile(wo, ((~scattered).sum(), 1)),
                               atol=1e-5)
    # throughput = exp(-a * travelled)
    travelled = np.where(scattered, d_free, 2.0)
    np.testing.assert_allclose(np.asarray(out.throughput)[:, 0],
                               np.exp(-0.1 * travelled), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out.t), travelled, rtol=1e-5)


def test_checker():
    out, _ = _scatter(sc.CHECKER, param=10.0, albedo=(1, 0, 0), color2=(0, 1, 0))
    thr = np.asarray(out.throughput)
    # hit_p = 0.3 uniform: sin(3)^3 > 0? sin(3)≈0.141 → product > 0 → color2
    np.testing.assert_allclose(thr, [[0.0, 1.0, 0.0]] * len(thr), atol=1e-6)


def test_presets_table():
    from tpu_pathtracer.models.presets import ALL_PRESETS
    from tpu_pathtracer.models.scene import make_materials

    rows = [fn() for fn in ALL_PRESETS.values()]
    mats = make_materials(rows)
    assert mats.count == 9
    # tinted glass absorption = -log(color)/10 (scene_materials.h:79)
    import math
    tg = rows[list(ALL_PRESETS).index("model_tinted_glass")]
    np.testing.assert_allclose(tg["absorption"][0],
                               -math.log(0.0972942) / 10.0, rtol=1e-6)
