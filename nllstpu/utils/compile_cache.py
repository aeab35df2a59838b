"""Persistent XLA compilation cache placement.

One rule for every entry point (tests, ``bench.py``, ``chip_smoke.py``,
the scripts): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and this module sets no directory; otherwise the cache lives at the fixed
``<repo>/.jax_cache`` (listed in ``.gitignore``).  The path is part of the
cache key, so a directory that moves between runs never hits.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache(min_compile_time_secs: float = 0.0) -> str:
    """Enable the persistent compilation cache and return its directory.

    Programs that compile faster than ``min_compile_time_secs`` are not
    written to the cache."""
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
    )
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
