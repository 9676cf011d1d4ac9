"""The compile-cache rule of utils/cache.py: JAX_COMPILATION_CACHE_DIR when
set (and nothing else set), otherwise the fixed <repo>/.jax_cache."""

from pathlib import Path

import jax
import pytest

from ray_tracing_extended_tpu.utils import cache

REPO = Path(__file__).resolve().parents[1]


def test_env_var_wins_and_nothing_is_set():
    path, must_set = cache.compile_cache_dir({cache.ENV_VAR: "/some/dir"})
    assert (path, must_set) == ("/some/dir", False)


def test_default_is_fixed_repo_path():
    path, must_set = cache.compile_cache_dir({})
    assert must_set
    assert Path(path) == REPO / ".jax_cache"
    assert cache.compile_cache_dir({})[0] == path  # no PID, time or tmpdir
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_enable_sets_default_when_unset(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.enable_compile_cache() == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")


def test_enable_leaves_config_alone_when_env_set(
    monkeypatch, restore_cache_dir, tmp_path
):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None
