"""Where the persistent compile cache goes (utils/cache.py)."""
import os

import jax
import pytest

from raytracing_tpu.utils import cache


def test_environment_variable_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_default_is_repo_local(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(repo, ".jax_cache")


def test_enable_points_jax_at_the_cache_dir(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    target = tmp_path / "cc"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    monkeypatch.delenv("RT_NO_CACHE", raising=False)
    try:
        assert cache.enable_persistent_cache() == str(target)
        assert jax.config.jax_compilation_cache_dir == str(target)
        assert target.is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("flag,expected_none", [("1", True), ("0", False)])
def test_rt_no_cache_disables(monkeypatch, tmp_path, flag, expected_none):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("RT_NO_CACHE", flag)
    try:
        assert (cache.enable_persistent_cache() is None) == expected_none
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
