"""Persistent XLA compilation cache.

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX keeps its cache there and this
  module sets no other directory.
- Otherwise, on the GPU: the fixed ``<checkout>/.jax_cache`` (ignored by
  git).  The path is part of the cache key, so it must not move between
  runs.
- Otherwise, on the CPU: no cache.  XLA:CPU executable serialization
  (``executable.serialize()`` inside the cache write) has segfaulted
  mid-test-run, and CPU executables are specialised to the host's CPU
  features.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir(platform: str, environ=os.environ) -> str | None:
    """Where a process on ``platform`` keeps its compile cache (None: no
    cache)."""
    if environ.get(ENV):
        return environ[ENV]
    return DEFAULT_DIR if platform == "gpu" else None


def enable_persistent_cache() -> str | None:
    """Turn the cache on for the current backend and return its directory.
    Call it after the platform is chosen: it starts the backend."""
    import jax

    path = cache_dir(jax.default_backend())
    if path is not None and not os.environ.get(ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
