"""Runtime configuration: the persistent compilation cache."""

from __future__ import annotations

import os

# the checkout this package runs from (its .jax_cache is gitignored)
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_cache_enabled = False


def compile_cache_dir(environ=os.environ) -> str | None:
    """Where the persistent compilation cache lives: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX then reads it itself and this
    package sets nothing), else <checkout>/.jax_cache."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> None:
    """Enable JAX's persistent compilation cache (idempotent).

    PFV pipelines compile one program per video geometry; the cache makes
    CLI and fresh-process use cheaper. CPU compiles are not cached (their
    entries are pinned to the host's machine features)."""
    global _cache_enabled
    if _cache_enabled:
        return
    import jax

    path = compile_cache_dir()
    if path is None or jax.default_backend() == "cpu":
        return
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    _cache_enabled = True
