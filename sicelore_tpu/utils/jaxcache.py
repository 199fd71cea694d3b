"""Persistent XLA compile cache: one rule for every entry point.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no other
directory is set here. Otherwise the cache lives at a fixed path inside
the checkout (`.jax_cache/`, git-ignored): the directory is part of the
cache key, so a path that moved between processes would never hit.
"""
from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Path:
    """The directory this process's compiles are cached in."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else CHECKOUT_CACHE


def enable_compile_cache() -> Path:
    """Turn the persistent cache on for this process; returns its dir.
    Every executable is cached, however small or quick to compile: a
    fresh process then pays no compile at all for shapes seen before."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return cache_dir()
