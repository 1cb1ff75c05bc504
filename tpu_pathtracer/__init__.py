"""tpu_pathtracer — a Monte-Carlo path tracer in JAX for one or more GPUs.

A rebuild of the capabilities of the reference CUDA renderer
(`voxel-tracer/cuda-raytracing-optimized`); the package name is a
leftover of the accelerator it was first written for.

* **Wavefront pipeline** instead of the reference megakernel
  (kernels.cu:535): SoA path-state batches, fixed-shape per-bounce stages
  under ``lax.while_loop``, masked lanes instead of warp divergence.
* **Implicit-heap BVH** stored as SoA ``float32`` arrays, traversed with a
  vectorized bounded loop (semantics of the reference's dual-node bitstack
  traversal, kernels.cu:154–224).
* **Counter-based RNG** keyed by (pixel, sample, bounce, slot) replacing the
  serial per-pixel xorshift stream (rnd.h) — reproducible under any
  parallel decomposition.
* **Multi-device** scaling by image-tile sharding over a ``jax.sharding.Mesh``
  with no collectives in the bounce loop.
"""

from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.camera import Camera, make_camera
from tpu_pathtracer.engine.render import Renderer, render_image

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "make_camera",
    "Renderer",
    "render_image",
    "__version__",
]
