"""Persistent XLA compilation cache location, shared by every entry point.

`JAX_COMPILATION_CACHE_DIR`, when set, names the directory and nothing else
is set.  Otherwise the cache lives at `<checkout>/.jax_cache` (listed in
.gitignore): a fixed path, because the path is part of the cache key.
"""

from __future__ import annotations

import os

import jax

__all__ = ["compile_cache_dir", "enable_compile_cache"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir().
    Works after jax has been imported.  Returns the directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
