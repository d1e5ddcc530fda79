"""utils.cache: where the persistent compilation cache lives."""

import os

import jax

from cosc_4397_pathtracing_raytracing_project_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_set_means_no_directory_in_code():
    assert cache.cache_dir_to_set({cache.ENV_VAR: "/some/dir"}) is None


def test_env_var_unset_means_fixed_checkout_dir():
    path = cache.cache_dir_to_set({})
    assert path == os.path.join(REPO, ".jax_cache")
    assert cache.cache_dir_to_set({cache.ENV_VAR: ""}) == path


def test_enable_compile_cache(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", before)
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before  # untouched
        monkeypatch.delenv(cache.ENV_VAR)
        assert cache.enable_compile_cache() == cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
