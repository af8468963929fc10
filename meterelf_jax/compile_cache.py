"""Where JAX keeps its persistent compilation cache.

Compiling the decode graph takes seconds to minutes per shape, so every
entry point keeps compiled programs across processes. The cache key
includes the directory's path, so the directory must not move between
runs: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX
reads it itself and nothing else is changed), else ``.jax_cache`` at the
root of the checkout.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX at the persistent cache directory; returns it. Call
    before the first compilation of the process."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
