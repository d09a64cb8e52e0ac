"""Persistent XLA compilation cache placement for scripts that drive the
library (``chip_smoke.py``, ``bench.py``, ``benchmarks/``).

``JAX_COMPILATION_CACHE_DIR`` wins when it is set. Otherwise the cache
lives in a fixed directory inside the checkout (``.jax_cache/``, listed in
``.gitignore``): the directory path is part of the cache key, so a path that
moves between runs would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["DEFAULT_CACHE_DIR", "compile_cache_dir", "enable_compile_cache"]

#: in-checkout default (the package's parent directory is the checkout root)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """Where the compilation cache goes: the env variable, else the default."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    and cache every compiled program (the defaults skip fast compiles).
    Call before the first compilation. Returns the directory used."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
