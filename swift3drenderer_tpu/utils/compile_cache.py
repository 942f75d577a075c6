"""Where JAX keeps compiled programs between runs.

A cold run of a large frame compiles for tens of seconds; the persistent
cache makes the next process start warm. The cache path is part of the key,
so it is fixed: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it
(JAX reads that itself), otherwise ``.jax_cache`` at the root of the repo.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory. Sets no
    directory when the environment names one."""
    path = compile_cache_dir()
    if path == REPO_CACHE_DIR:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
