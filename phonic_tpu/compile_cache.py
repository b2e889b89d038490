"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, names the directory and JAX reads
it itself; otherwise the cache goes to a fixed directory the caller names
(inside the checkout, so a later run from the same checkout hits it).
"""

from __future__ import annotations

import os


def use_compile_cache(default_dir: str, min_compile_secs: float = 1.0) -> str:
    """Enable the persistent compile cache; returns the directory in use."""
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or default_dir
    if cache == default_dir:
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return cache
