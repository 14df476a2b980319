"""Persistent XLA compile cache for scripts that drive the library.

The library import sets nothing; entry-point scripts (``chip_smoke.py``,
``bench.py``, ``examples/*.py``) call :func:`enable_compile_cache` once at
start-up, before their first compilation.
"""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

#: ``<checkout>/.jax_cache``: a fixed path (the cache key includes it, so a
#: directory that moves between runs never hits).  Listed in .gitignore.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself; nothing else is set), else point ``jax_compilation_cache_dir``
    at :data:`DEFAULT_CACHE_DIR`.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
