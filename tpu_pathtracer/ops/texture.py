"""Image-texture sampling from a padded atlas stack.

The reference stores each texture as a separate device buffer and fetches
nearest-neighbor texels with wrap addressing inline in the megakernel
(kernels.cu:456–476). A ragged array of pointers is a GPU-ism; here all K
textures live in one ``[K, Hmax, Wmax, 3]`` padded stack with per-texture
true sizes, so a batch of lookups is one gather.
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp
import numpy as np


def build_atlas(images: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack float32 HxWx3 images into a padded stack.

    Returns (atlas [K,Hmax,Wmax,3], widths [K], heights [K]).
    """
    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    k = len(images)
    atlas = np.zeros((k, hmax, wmax, 3), np.float32)
    widths = np.zeros((k,), np.int32)
    heights = np.zeros((k,), np.int32)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        atlas[i, :h, :w] = im[..., :3]
        widths[i] = w
        heights[i] = h
    return atlas, widths, heights


def fetch(atlas: jnp.ndarray, widths: jnp.ndarray, heights: jnp.ndarray,
          tex_id: jnp.ndarray, tu: jnp.ndarray, tv: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbor wrap-addressed texel fetch (kernels.cu:460–472).

    tex_id < 0 lanes return garbage texels the caller must mask (matching
    the ``mat.texId != -1`` guard at kernels.cu:458).
    """
    tid = jnp.maximum(tex_id, 0)
    w = widths[tid]
    h = heights[tid]
    # wrap: tu - floor(tu), kernels.cu:462–465
    fu = tu - jnp.floor(tu)
    fv = tv - jnp.floor(tv)
    tx = ((w - 1).astype(jnp.float32) * fu).astype(jnp.int32)
    ty = ((h - 1).astype(jnp.float32) * fv).astype(jnp.int32)
    return atlas[tid, ty, tx]


def load_texture(path: str) -> np.ndarray:
    """Load an image file to float32 HxWx3 in [0,1], vertically flipped —
    matching stbi_set_flip_vertically_on_load(true) + forced 3 channels +
    byte/255 conversion (staircase_scene.h:103–118, :121). Needs Pillow,
    which only this loader of external image files uses."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"loading the texture {path!r} needs Pillow (pip install "
            "pillow); procedural scenes need no image files") from e

    im = Image.open(path).convert("RGB")
    arr = np.asarray(im, np.float32) / 255.0
    return arr[::-1].copy()  # flip vertically


def checkerboard_texture(size: int = 64, cells: int = 8,
                         c0=(0.9, 0.9, 0.9), c1=(0.2, 0.2, 0.2)) -> np.ndarray:
    """Procedural stand-in texture (the staircase PNG assets are not
    shipped with the reference — staircase_scene.h:122 points at absolute
    local paths)."""
    y, x = np.mgrid[0:size, 0:size]
    parity = ((x * cells // size) + (y * cells // size)) % 2
    out = np.where(parity[..., None] == 0,
                   np.asarray(c0, np.float32), np.asarray(c1, np.float32))
    return out.astype(np.float32)
