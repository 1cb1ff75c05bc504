"""Profiling + throughput telemetry.

The reference profiles externally with nvprof (Makefile:29–34) and counts
rays via atomic STATS counters (kernels.cu:48–67). Equivalents here:

  * :func:`trace` — context manager around ``jax.profiler`` producing a
    TensorBoard-loadable trace directory;
  * :func:`measure` — wall-clock + rays/sec for a render callable, using
    the masked-sum Stats counters for exact ray accounting.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/tpu_pathtracer_trace"):
    """Capture a device profile around a block:

        with profiling.trace("/tmp/tr"):
            render_image(scene, cam, cfg)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class Measurement:
    def __init__(self, seconds: float, rays: Optional[int], paths: int):
        self.seconds = seconds
        self.rays = rays
        self.paths = paths

    @property
    def mrays_per_sec(self) -> Optional[float]:
        return None if self.rays is None else self.rays / self.seconds / 1e6

    @property
    def mpaths_per_sec(self) -> float:
        return self.paths / self.seconds / 1e6

    def __repr__(self):
        parts = [f"{self.seconds:.3f}s", f"{self.mpaths_per_sec:.1f} Mpaths/s"]
        if self.rays is not None:
            parts.append(f"{self.mrays_per_sec:.1f} Mrays/s")
        return "Measurement(" + ", ".join(parts) + ")"


def measure(scene, camera, config, renderer: Optional[Callable] = None,
            count_rays: bool = False) -> Measurement:
    """Time a warm render; optionally run a stats pass for exact ray
    counts (primary + secondary + shadow — the reference's NUM_RAYS_*
    accounting, kernels.cu:116–137)."""
    from tpu_pathtracer.engine.render import render_image

    render = renderer or render_image
    render(scene, camera, config)  # warm / compile
    t0 = time.perf_counter()
    render(scene, camera, config)
    seconds = time.perf_counter() - t0

    rays = None
    if count_rays:
        scfg = config.replace(ns=min(config.ns, 4), stats=True)
        _, stats = render_image(scene, camera, scfg, report_stats=True)
        per_spp = (stats.primary + stats.secondary + stats.shadows) / scfg.ns
        rays = int(per_spp * config.ns)
    return Measurement(seconds, rays, config.num_pixels * config.ns)
