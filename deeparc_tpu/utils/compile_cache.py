"""The persistent XLA compilation cache: one directory for every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and nothing else
is set; otherwise the cache is ``.jax_cache/`` at the root of the checkout
(listed in ``.gitignore``). A fixed path matters: the path is part of the
cache key, so a directory that moves never hits. The CLI, ``bench.py``,
``chip_smoke.py`` and the test suite all call :func:`enable_compile_cache`.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` or
    ``<checkout>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 0.5,
                         min_entry_bytes: int | None = None) -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    (call before the first compile). Returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    if min_entry_bytes is not None:
        jax.config.update("jax_persistent_cache_min_entry_size_bytes",
                          min_entry_bytes)
    return path
