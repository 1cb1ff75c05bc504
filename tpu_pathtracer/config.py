"""Render configuration.

The reference uses compile-time ``#define``s as its config system
(kernels.cu:13–24: STATS, RUSSIAN_ROULETTE, BVH, SHADOW, TEXTURES, EPSILON,
DUAL_NODES, USE_BVH_TEXTURE) plus hardcoded driver constants
(main.cpp:62–74). Here all of them are runtime options in one dataclass.

Fields are hashable / static so a config can be closed over by ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
import warnings


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All knobs of the renderer, mirroring the reference's defines + argv.

    Attributes:
      nx, ny: image resolution (main.cpp:65–66).
      ns: samples per pixel (main.cpp:67).
      max_depth: bounce limit (main.cpp:68, argv[1] main.cpp:73–74).
      epsilon: self-intersection t_min (kernels.cu:19 ``EPSILON 0.01f``).
      russian_roulette: enable RR after bounce 3 (kernels.cu:14, :512–527).
      rr_start_bounce: first bounce index at which RR applies
        (``p.bounce > 3`` kernels.cu:514).
      shadow: next-event-estimation shadow rays toward the sphere light
        (kernels.cu:16, :362–393). When True, specular light hits add
        nothing — reproducing the reference's as-built quirk
        (kernels.cu:440–446). When False, specular light hits add
        attenuation*lightColor (kernels.cu:444).
      use_bvh: accelerate mesh intersection with the BVH (kernels.cu:15);
        False falls back to brute-force all-triangles (kernels.cu:307–321),
        kept as the slow oracle path.
      textures: enable image-texture albedo lookups (kernels.cu:17).
      stats: collect ray-accounting counters (kernels.cu:13, :48–67) as
        masked sums.
      samples_per_batch: how many samples-per-pixel are traced per wavefront
        launch; the outer loop accumulates batches into the framebuffer.
      rays_per_chunk: pixels*samples are processed in chunks of this many
        lanes to bound peak memory (0 = single chunk).
      check_nans: count NaN radiance samples like NUM_RAYS_NAN
        (kernels.cu:63, :560) into Stats.nans — requires ``stats=True``
        to be collected/reported (both engines agree on this contract).

    Geometry compute dtype is always float32 (bf16 is too coarse for
    ray-scene intersection); BVH traversal depth is bounded at 32 by the
    uint32 bitstack and validated at mesh load/traverse time.
    """

    nx: int = 640
    ny: int = 800
    ns: int = 256
    max_depth: int = 64
    epsilon: float = 0.01
    russian_roulette: bool = True
    rr_start_bounce: int = 3
    shadow: bool = True
    use_bvh: bool = True
    textures: bool = True
    stats: bool = False
    samples_per_batch: int = 0  # 0 = auto
    rays_per_chunk: int = 0  # 0 = auto
    flush_window: int = 0  # regen flush window rows: the pixel-flush
    # one-hot adds into a W-row dynamic slice of the [rounds, m]
    # accumulator instead of rewriting every row; lanes more than W-1
    # rounds ahead of the slowest stall their flush (radiance
    # bit-identical — tested). 0 = full one-hot, the default. Its speed
    # on the GPU is not measured.
    check_nans: bool = False

    @property
    def num_pixels(self) -> int:
        return self.nx * self.ny

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> list:
        """Knob combos that would otherwise no-op silently (the
        reference's #define matrix, kernels.cu:13–24, fails such combos
        at compile time). Returns the list of warning strings;
        ``__post_init__`` emits them as RuntimeWarnings so every
        constructed config is checked."""
        w = []
        if self.check_nans and not self.stats:
            w.append("check_nans counts into Stats.nans, which is "
                     "only collected/reported when stats=True")
        return w

    def __post_init__(self):
        for msg in self.validate():
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
