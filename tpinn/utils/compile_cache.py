"""JAX's persistent compilation cache, set up in one place.

Every entry point (the CLI, ``serve``, the lite app, ``bench.py``,
``chip_smoke.py`` and ``scripts/accuracy.py``) calls
``enable_compile_cache()`` before its first compilation, so a second run
of the same shapes loads compiled programs instead of rebuilding them.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache: a fixed path (it is part of the cache key), listed
# in .gitignore
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Path:
    """The directory the cache uses: ``$JAX_COMPILATION_CACHE_DIR`` when
    it is set, else ``<checkout>/.jax_cache``."""
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else DEFAULT_DIR


def enable_compile_cache() -> Path:
    """Point JAX's compilation cache at ``cache_dir()`` and return it."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", str(path))
    return path
