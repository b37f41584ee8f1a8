"""Persistent XLA compilation cache for cold-start latency.

In-process executables are already reused (samplers cache per log-density fn
with data as an operand), but a fresh process pays the full trace+compile.
XLA's persistent cache removes that across processes. Opt-in: the CLI, the
benchmarks and chip_smoke.py enable it; library imports never mutate global
JAX config.

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads
that variable itself, and this module then sets no directory), otherwise
the fixed directory `.jax_cache` at the root of the checkout. The path is
part of the cache key, so it never depends on a temporary name, a pid or
the time. `PPCSEQ_COMPILATION_CACHE=0` turns the cache off.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def enable() -> str | None:
    """Enable JAX's persistent compilation cache; returns the dir (or None)."""
    if os.environ.get("PPCSEQ_COMPILATION_CACHE") == "0":
        return None
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
