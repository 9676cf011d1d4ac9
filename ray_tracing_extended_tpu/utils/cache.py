"""Persistent XLA compile cache for the entry points (CLI, bench, smoke).

A cold 1080p program takes many seconds to compile; the cache keeps it
across processes. The rule, applied by ``enable_compile_cache``:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing else is
  set.
* unset: ``<repo>/.jax_cache`` (listed in ``.gitignore``). The path is part
  of the cache key, so it is fixed - never a temporary directory, a PID or
  a time.

Called by entry points only, never at package import: importing a library
must not change a process's JAX configuration.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ=None) -> tuple[str, bool]:
    """-> (cache directory, whether this process must set it itself)."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV_VAR):
        return environ[ENV_VAR], False
    return str(DEFAULT_DIR), True


def enable_compile_cache() -> str:
    """Apply the rule above before the first compilation; -> the directory."""
    import jax

    path, must_set = compile_cache_dir()
    if must_set:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
