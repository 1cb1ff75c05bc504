"""Persistent XLA compilation cache.

The render graphs (regeneration loop, BVH traversal) take a long time to
compile; caching them across processes makes the CLI and the bench
usable. The cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is
set, else in ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import os


def cache_dir() -> str:
    """Where :func:`enable_compilation_cache` keeps compiled programs."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, ".jax_cache")


def enable_compilation_cache() -> str:
    """Point JAX's persistent cache at :func:`cache_dir`; returns it."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    return path
