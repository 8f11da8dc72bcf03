"""JAX's persistent compilation cache, in one fixed place per checkout.

Whole-run ``lax.scan`` programs take tens of seconds to compile; the cache
lets a second process (or a second run of the CLI, the bench or the smoke
script) load them instead. The cache key includes the directory, so the
directory must not move between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache, derived from this package's own location
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing else is set here; otherwise the cache goes to ``DEFAULT_DIR``.
    """
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
