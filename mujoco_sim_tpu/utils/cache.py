"""Placement of JAX's persistent compilation cache.

Every entry point (bench, chip smoke, the test suite, scripts) calls
``use_compile_cache`` before its first compile, so all of them share one
cache. ``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the
cache lives at ``<repo>/.jax_cache``. The path is part of the cache key,
so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# programs that compile faster than this are not worth a cache entry
MIN_COMPILE_SECS = 5.0


def compile_cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".jax_cache"))


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    and cache only programs that took at least ``MIN_COMPILE_SECS``."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECS)
    return path
