"""Where JAX keeps compiled programs between processes.

The full-size chunk program takes minutes to compile, so every entry
point turns on JAX's persistent compilation cache before its first
compile. The cache directory is part of each entry's key, so it must
not move between runs: `$JAX_COMPILATION_CACHE_DIR` when the
environment sets it, else one fixed directory inside the checkout.
"""

from __future__ import annotations

import os

from slam_toolkit_tpu.utils.paths import CHECKOUT

CHECKOUT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at
    `$JAX_COMPILATION_CACHE_DIR`, else at CHECKOUT_CACHE_DIR; returns
    the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
