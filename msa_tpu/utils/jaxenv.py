"""JAX environment setup shared by the CLI, bench, smoke script and tests.

Import before JAX starts a backend. Turns on the persistent compilation
cache: in ``$JAX_COMPILATION_CACHE_DIR`` when that is set, otherwise in one
fixed directory inside the checkout (``DEFAULT_CACHE_DIR``, git-ignored).
A fixed path matters: it is part of the cache key, so a moving directory
never hits.
"""

from __future__ import annotations

import os
import sys

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_jax_env() -> str:
    """Set the cache environment; returns the cache directory in use."""
    cache_dir = os.environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR", DEFAULT_CACHE_DIR
    )
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
    if "jax" in sys.modules:
        # JAX reads these variables when it is imported; one imported
        # earlier needs the live config set too.
        import jax

        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir


setup_jax_env()
