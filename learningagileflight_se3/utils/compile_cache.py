"""JAX's persistent compilation cache, set up the same way by every entry
point (bench.py, chip_smoke.py, scripts/train_pipeline.py, benchmarks/*.py).

With JAX_COMPILATION_CACHE_DIR set, JAX uses that directory and nothing is
changed here.  Without it, the cache lives at the fixed path
<repo>/.jax_cache (git-ignored): a fixed path, because the path is part of
the cache key and a directory that moves never hits."""

from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
