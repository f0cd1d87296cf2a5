"""Persistent XLA compilation cache.

A cold compile of a trace program costs seconds to minutes; JAX's
persistent compilation cache lets a second process load the serialized
executable instead of recompiling.

``enable_persistent_cache()`` is called by the entry points that pay
repeated compiles — bench.py, chip_smoke.py, __graft_entry__.py and the
serve daemon.  The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says,
and otherwise at the fixed repo-local ``.jax_cache/``.  It is a no-op when
``RT_NO_CACHE=1`` (for cold-compile measurements).
"""
from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else the repo-local dir."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_DIR


def enable_persistent_cache() -> str | None:
    """Point JAX's compilation cache at :func:`cache_dir`.

    Returns the cache dir actually set, or None if disabled.  Safe to call
    multiple times and before/after backend init; caches are keyed by
    backend + program, so CPU test runs and GPU runs coexist in one
    directory.
    """
    if os.environ.get("RT_NO_CACHE", "0") == "1":
        return None
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    # cache everything: even small compiles are worth persisting
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    os.makedirs(path, exist_ok=True)
    return path
