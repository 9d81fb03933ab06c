"""Persistent XLA compilation cache for the program's entry points.

Called by the CLI, bench.py, chip_smoke.py and the test configuration;
importing the library does not call it. The cache directory is part of
each entry's key, so it stays at one fixed path per checkout.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Keep compiled programs across processes; returns the directory.

    JAX_COMPILATION_CACHE_DIR wins when set (JAX reads it itself, so
    nothing is set here); otherwise the cache goes to
    <checkout>/.jax_cache, which .gitignore lists."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
