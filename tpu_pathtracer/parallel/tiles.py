"""Multi-device rendering: image tiles sharded over a device mesh.

The reference is strictly single-GPU (SURVEY §2 parallelism table:
``cudaDeviceReset`` kernels.cu:679, zero collectives). The scaling
design here: shard the flat pixel axis over
a 1-D ``jax.sharding.Mesh``, give every lane its counter-based RNG stream
keyed by *global* pixel id (so the tiled render is bit-identical to the
single-device render), and keep the bounce loop collective-free — each
device runs its own ``while_loop`` and exits independently; the only
cross-device traffic is the final framebuffer gather (one all-gather worth
of pixels per frame) and a scalar psum for the optional stats.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map as _shard_map  # jax>=0.6 (check_vma kwarg)

from tpu_pathtracer.camera import Camera
from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.engine.render import sample_sum
from tpu_pathtracer.engine.wavefront import Stats
from tpu_pathtracer.models.scene import Scene

AXIS = "tiles"


def make_tile_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


@functools.partial(jax.jit, static_argnames=("config", "ns", "mesh"))
def _render_tiles(scene: Scene, camera: Camera, config: RenderConfig,
                  pixel_ids: jnp.ndarray, valid: jnp.ndarray,
                  s0: jnp.ndarray, ns: int,
                  mesh: Mesh) -> Tuple[jnp.ndarray, Stats]:
    def per_device(scene, camera, ids, valid, s0):
        acc, stats = sample_sum(scene, camera, config, ids, ns, s0,
                                valid=valid)
        # stats are tiny scalars; one psum outside the bounce loop
        stats = jax.lax.psum(stats, AXIS)
        return acc / jnp.float32(ns), stats

    fn = _shard_map(per_device, mesh=mesh,
                    in_specs=(P(), P(), P(AXIS), P(AXIS), P()),
                    out_specs=(P(AXIS), P()))
    return fn(scene, camera, pixel_ids, valid, s0)


@functools.partial(jax.jit, static_argnames=("config", "num_pixels", "mesh",
                                             "normalize"))
def _render_tiles_regen(scene: Scene, camera: Camera, config: RenderConfig,
                        offsets: jnp.ndarray, ns: jnp.ndarray,
                        s0: jnp.ndarray, num_pixels: int, mesh: Mesh,
                        normalize: bool = True) -> jnp.ndarray:
    from tpu_pathtracer.engine.regen import render_regen

    def per_device(scene, camera, offset, ns, s0):
        return render_regen(scene, camera, config, ns=ns,
                            pixel_offset=offset[0],
                            num_pixels=num_pixels, s0=s0,
                            normalize=normalize)

    fn = _shard_map(per_device, mesh=mesh,
                    in_specs=(P(), P(), P(AXIS), P(), P()),
                    out_specs=P(AXIS))
    return fn(scene, camera, offsets, ns, s0)


def render_tiled_regen(scene: Scene, camera: Camera, config: RenderConfig,
                       devices: Optional[Sequence[jax.Device]] = None,
                       ns: Optional[int] = None, s0: int = 0,
                       normalize: bool = True) -> jax.Array:
    """Dispatch the tile-sharded regeneration render and return the
    ``[devices * per_device, 3]`` framebuffer still sharded over the
    devices (tail rows past the frame are padding). Each device owns a
    contiguous pixel stripe and runs its own regen loop to completion —
    zero collectives anywhere."""
    mesh = make_tile_mesh(devices)
    d = mesh.devices.size
    n = config.num_pixels
    per_dev = (n + d - 1) // d
    offsets = jnp.asarray(np.arange(d, dtype=np.uint32) * per_dev)
    sharding = NamedSharding(mesh, P(AXIS))
    offsets = jax.device_put(offsets, sharding)
    scene = jax.device_put(scene, NamedSharding(mesh, P()))
    camera = jax.device_put(camera, NamedSharding(mesh, P()))
    # NOTE: per_dev*d may exceed n; tail lanes render clamped pixel ids and
    # are dropped by the caller.
    return _render_tiles_regen(scene, camera, config, offsets,
                               jnp.uint32(config.ns if ns is None else ns),
                               jnp.uint32(s0), per_dev, mesh,
                               normalize=normalize)


def render_image_tiled_regen(scene: Scene, camera: Camera,
                             config: RenderConfig,
                             devices: Optional[Sequence[jax.Device]] = None,
                             ns: Optional[int] = None, s0: int = 0,
                             normalize: bool = True) -> np.ndarray:
    """Tile-sharded render using the regeneration engine, gathered to the
    host as ``[ny, nx, 3]``. Bit-identical per-path radiance to the
    single-device regen render.

    ``s0``/``normalize=False`` give the tiled sample-range primitive for
    checkpointed multi-device renders (BASELINE config 5): sums over
    disjoint sample ranges partition exactly.
    """
    fb = render_tiled_regen(scene, camera, config, devices, ns, s0,
                            normalize)
    n = config.num_pixels
    return np.asarray(fb)[:n].reshape(config.ny, config.nx, 3)


def render_image_tiled(scene: Scene, camera: Camera, config: RenderConfig,
                       devices: Optional[Sequence[jax.Device]] = None,
                       report_stats: bool = False):
    """Render the frame tiled across devices. Bit-identical to the
    single-device :func:`~tpu_pathtracer.engine.render.render_image`
    because RNG streams are keyed by global pixel id.

    Samples are traced in batches of ``config.samples_per_batch`` (0 =
    all at once) to bound per-device live state.
    """
    mesh = make_tile_mesh(devices)
    d = mesh.devices.size
    n = config.num_pixels
    n_pad = ((n + d - 1) // d) * d
    raw = np.arange(n_pad, dtype=np.uint32)
    ids = np.minimum(raw, n - 1)
    sharding = NamedSharding(mesh, P(AXIS))
    ids = jax.device_put(jnp.asarray(ids), sharding)
    valid = jax.device_put(jnp.asarray(raw < n), sharding)
    scene = jax.device_put(scene, NamedSharding(mesh, P()))
    camera = jax.device_put(camera, NamedSharding(mesh, P()))

    batch = config.samples_per_batch or config.ns
    acc = None
    stats_total = Stats.zeros()
    done = 0
    while done < config.ns:
        take = min(batch, config.ns - done)
        out, stats = _render_tiles(
            scene, camera, config, ids, valid, jnp.uint32(done), take, mesh)
        # out is already mean over `take`; re-weight into running mean
        out = np.asarray(out) * (take / config.ns)
        acc = out if acc is None else acc + out
        stats_total = jax.tree.map(lambda a, b: a + b, stats_total, stats)
        done += take

    img = np.asarray(acc)[:n].reshape(config.ny, config.nx, 3)
    if report_stats:
        return img, jax.tree.map(int, stats_total)
    return img
