"""Host-facing render API.

Mirrors the reference's 3-call ``extern "C"`` lifecycle (kernels.h:6–8:
initRenderer / runRenderer / cleanupRenderer) with a :class:`Renderer`
class, plus a one-shot :func:`render_image`. ``device_put`` replaces the
cudaMalloc/cudaMemcpy choreography (kernels.cu:571–650); XLA owns the
kernel launches.

Work decomposition: pixels are processed in fixed-size lane chunks (one
compiled program reused across chunks) and samples accumulate in an inner
``fori_loop`` — so arbitrarily large (resolution × spp) renders run in
bounded memory, the analogue of the reference's grid-of-blocks launch
(kernels.cu:657–659).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pathtracer.camera import Camera
from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.engine.wavefront import Stats, trace
from tpu_pathtracer.models.scene import Scene


def auto_chunk(config: RenderConfig) -> int:
    """Lane-chunk size: bounds the [lanes × scene-primitives] intermediates.

    Auto picks 128Ki lanes or the whole image if smaller.
    """
    if config.rays_per_chunk:
        return int(config.rays_per_chunk)
    return min(config.num_pixels, 1 << 17)


def sample_sum(scene: Scene, camera: Camera, config: RenderConfig,
               pixel_ids: jnp.ndarray, ns: int, s0=0,
               valid: Optional[jnp.ndarray] = None
               ) -> Tuple[jnp.ndarray, Stats]:
    """Sum of radiance over samples ``[s0, s0+ns)`` for a chunk of lanes.

    The sample loop is the reference's ``for s in 0..ns`` (kernels.cu:548)
    hoisted outside the bounce loop. ``valid`` masks tail-padding duplicate
    lanes out of the Stats counters.
    """
    s0 = jnp.asarray(s0, jnp.uint32)

    def body(s, carry):
        acc, stats = carry
        col, st = trace(scene, camera, config, pixel_ids,
                        s0 + s.astype(jnp.uint32), valid=valid)
        stats = jax.tree.map(lambda a, b: a + b, stats, st)
        return acc + col, stats

    # inits derived from inputs so carry varyance matches under shard_map
    zf = pixel_ids.astype(jnp.float32) * 0.0
    zstat = jnp.sum(zf).astype(jnp.int32)
    return jax.lax.fori_loop(
        0, ns, body,
        (jnp.zeros((pixel_ids.shape[0], 3), jnp.float32) + zf[:, None],
         jax.tree.map(lambda s: s + zstat, Stats.zeros())))


@functools.partial(jax.jit, static_argnames=("config", "ns"))
def _render_chunk(scene: Scene, camera: Camera, config: RenderConfig,
                  pixel_ids: jnp.ndarray, valid: jnp.ndarray,
                  ns: int) -> Tuple[jnp.ndarray, Stats]:
    """Mean radiance over ``ns`` samples for one chunk of pixel lanes; the
    framebuffer stores linear mean radiance with no gamma (``col/ns``,
    kernels.cu:564–568)."""
    acc, stats = sample_sum(scene, camera, config, pixel_ids, ns, valid=valid)
    return acc / jnp.float32(ns), stats


def render_image(scene: Scene, camera: Camera, config: RenderConfig,
                 report_stats: bool = False):
    """Render the full frame. Returns ``[ny, nx, 3]`` float32 linear
    radiance (row j=0 at the bottom, matching pixelId = j*nx + i,
    kernels.cu:541). With ``report_stats=True`` returns (image, Stats)."""
    n = config.num_pixels
    chunk = auto_chunk(config)
    num_chunks = (n + chunk - 1) // chunk
    fb = np.zeros((n, 3), np.float32)
    stats_total = Stats.zeros()
    for c in range(num_chunks):
        start = c * chunk
        raw = jnp.arange(start, start + chunk, dtype=jnp.uint32)
        ids = jnp.minimum(raw, jnp.uint32(n - 1))  # tail padding
        valid = raw < jnp.uint32(n)  # pads excluded from Stats
        out, stats = _render_chunk(scene, camera, config, ids, valid,
                                   config.ns)
        take = min(chunk, n - start)
        fb[start:start + take] = np.asarray(out)[:take]
        stats_total = jax.tree.map(lambda a, b: a + b, stats_total, stats)
    img = fb.reshape(config.ny, config.nx, 3)
    if report_stats:
        return img, jax.tree.map(lambda x: int(x), stats_total)
    return img


class Renderer:
    """Stateful facade over the init/run/cleanup lifecycle
    (kernels.cu:571–680)."""

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig):
        """initRenderer: place scene data on device (kernels.cu:571–650)."""
        self.config = config
        self.camera = camera
        self.scene = jax.device_put(scene)
        self._fb: Optional[np.ndarray] = None
        self.stats: Optional[Stats] = None

    def run(self, ns: Optional[int] = None) -> np.ndarray:
        """runRenderer (kernels.cu:652–664): trace ns samples/pixel and
        return the linear framebuffer [ny, nx, 3]."""
        cfg = self.config if ns is None else self.config.replace(ns=ns)
        out = render_image(self.scene, self.camera, cfg, report_stats=True)
        self._fb, self.stats = out
        return self._fb

    @property
    def framebuffer(self) -> Optional[np.ndarray]:
        return self._fb

    def print_stats(self) -> None:
        """printStats — the reference's exact 18-counter report
        (kernels.cu:116–137)."""
        if self.stats is None:
            return
        s = self.stats
        print("num rays:")
        rows = [("primary", s.primary),
                ("primary hit mesh", s.primary_hit_mesh),
                ("primary nohit", s.primary_nohit),
                ("primary bb nohit", s.primary_bbox_nohit),
                ("secondary", s.secondary),
                ("secondary no hit", s.secondary_nohit),
                ("secondary bb nohit", s.secondary_bbox_nohit),
                ("secondary mesh", s.secondary_mesh),
                ("secondary mesh nohit", s.secondary_mesh_nohit),
                ("shadows", s.shadows),
                ("shadows nohit", s.shadows_nohit),
                ("shadows bb nohit", s.shadows_bbox_nohit),
                ("power < 0.01", s.low_power),
                ("exceeded max bounce", s.exceed_max_bounce),
                ("russian roulette", s.roulette_kill),
                ("both nodes hit", s.nodes_both),
                ("single node hit", s.nodes_single)]
        for name, v in rows:
            print(f" {name:20s}: {v}")
        if int(s.nans) > 0:
            print(f"*** {s.nans} NaNs detected")

    def cleanup(self) -> None:
        """cleanupRenderer (kernels.cu:666–680): drop device references."""
        self.scene = None
        self._fb = None
