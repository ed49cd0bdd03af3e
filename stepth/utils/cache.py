"""Persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
changed. Otherwise compiled programs are kept in ``.jax_cache`` at the root of
the checkout — a fixed path, so later runs from the same checkout hit it.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
