"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (bench scripts, chip_smoke.py): when
JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing is set in
code; otherwise the cache lives at the fixed `<repo>/.jax_cache`, so a
later process in the same checkout finds it again.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Apply the rule above; returns the cache directory in use."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
