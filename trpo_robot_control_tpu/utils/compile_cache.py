"""Persistent compilation cache location, shared by every entry point."""
from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `<checkout>/.jax_cache`:
    one fixed path, since the path is part of what a cache hit needs."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir(). JAX reads
    JAX_COMPILATION_CACHE_DIR itself, so only the default is set here."""
    import jax
    path = cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
