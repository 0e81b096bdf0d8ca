"""Persistent XLA compilation cache for the repository's entry scripts.

``chip_smoke.py``, ``bench.py`` and the examples call
``enable_compile_cache()`` before their first compilation, so a second
process (a benchmark child, a rerun) loads compiled programs instead of
compiling them again.  The package itself sets no cache on import.

The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set, and
otherwise a fixed ``.jax_cache/`` at the repository root: the path is part
of what the cache matches on, so it must not move between runs.
"""

from __future__ import annotations

import os

__all__ = ["cache_dir", "enable_compile_cache"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory ``enable_compile_cache`` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()`` and
    return that directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
