"""JAX's persistent compilation cache, at one fixed place.

Every entry point (the smoke test, the benchmark, the scripts, the test
suite) calls ``enable_compile_cache()`` before its first compile:

- if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
  sets no directory of its own;
- otherwise the cache lives in ``<checkout>/.jax_cache`` (listed in
  ``.gitignore``). The path is fixed because it is part of the cache's key:
  a directory that moves never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
