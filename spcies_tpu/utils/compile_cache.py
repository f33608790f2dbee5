"""Where the scripts of this repository keep JAX's persistent compile cache."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is set here. Otherwise the cache goes to the fixed path
    <checkout>/.jax_cache: the path is part of the cache key, so it must
    not move between runs."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
