"""phonic_tpu/compile_cache.py: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise the cache goes to the caller's fixed directory."""

import jax
import pytest

from phonic_tpu.compile_cache import use_compile_cache


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_dir_choice(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    env_dir, default_dir = str(tmp_path / "env"), str(tmp_path / "repo")
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = use_compile_cache(default_dir)
        if env_set:
            assert got == env_dir
            # JAX reads the variable itself; no other directory is set
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert got == default_dir
            assert jax.config.jax_compilation_cache_dir == default_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_secs)
