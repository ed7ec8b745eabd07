"""Persistent XLA compilation cache setup.

The fused frame programs take tens of seconds to minutes to compile cold;
with the cache a later process loads them in seconds. Every CLI/bench entry
point calls ``enable_compilation_cache()``.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself, and this module then sets no directory), otherwise the
fixed ``<repo>/.jax_cache`` (listed in ``.gitignore``). ``MSF_JAX_CACHE=0``
disables the cache.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> bool:
    if os.environ.get("MSF_JAX_CACHE", "1") != "1":
        return False
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return True
