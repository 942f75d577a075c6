"""The persistent compile cache lives where the environment says, else at one
fixed path inside the repo."""

import os

import jax

from swift3drenderer_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    return updates


def test_environment_cache_dir_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    updates = _record_updates(monkeypatch)
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert updates == []  # JAX reads the variable itself; nothing else set


def test_fallback_cache_dir_is_in_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = _record_updates(monkeypatch)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert updates == [("jax_compilation_cache_dir", path)]
