"""Persistent XLA compilation cache: the query, fused-coverage and profile-tail
graphs take seconds to minutes to compile, so every entry point enables this
and a second process loads them instead of compiling again."""
from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Turn the persistent cache on and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the directory: JAX reads it
    itself and nothing is set here.  Otherwise the cache lives at the fixed
    path ``<checkout>/.jax_cache`` — a fixed path, because the directory is
    part of what a later process must find again."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    CHECKOUT_CACHE.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
