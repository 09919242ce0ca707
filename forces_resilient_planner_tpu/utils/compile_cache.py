"""Where JAX keeps its persistent compilation cache.

JAX_COMPILATION_CACHE_DIR, when set, is the deployment's choice: JAX
reads it at import and nothing here overrides it.  Otherwise the cache
lives at a fixed path given by the caller (inside the checkout), never a
temporary or per-process one: the directory must stay put for a later
process to find its entries.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def use_compile_cache(default_dir: str | Path,
                      min_compile_secs: float | None = None) -> str:
    """Point JAX's persistent cache at `default_dir` unless the env var
    names one; optionally set the minimum compile time worth caching.
    Returns the cache directory in use."""
    import jax

    if min_compile_secs is not None:
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    path = str(Path(default_dir).resolve())
    jax.config.update("jax_compilation_cache_dir", path)
    return path
