"""The persistent compile cache's directory rule (utils/hostenv.py)."""

import os

import pytest

from dsabeamformer.utils import hostenv


def test_cache_dir_from_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that directory, and nothing is set
    in code (JAX reads the variable itself)."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert hostenv.compile_cache_dir() == str(tmp_path)
    assert hostenv.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    """Unset: a fixed directory inside the checkout, set in JAX's
    config — never a temporary, per-process or time-based name."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert hostenv.compile_cache_dir() == want
    assert hostenv.enable_compile_cache() == want
    assert hostenv.enable_compile_cache() == want  # stable across calls
    assert calls == [("jax_compilation_cache_dir", want)] * 2


@pytest.mark.parametrize("value", ["", None])
def test_cache_dir_empty_env_is_unset(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
    assert hostenv.compile_cache_dir() == hostenv.DEFAULT_CACHE_DIR


def test_gitignore_lists_default_cache_dir():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
