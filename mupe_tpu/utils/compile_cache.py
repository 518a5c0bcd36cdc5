"""Where the persistent XLA compilation cache lives.

`setup_compile_cache()` is called by the entry points (`harness.train`,
`bench.py`, `chip_smoke.py`) before anything compiles.  When
`JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this sets
nothing; otherwise the cache goes to `<repo>/.jax_cache` (listed in
.gitignore), a fixed path so that later runs of the same checkout hit it.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
