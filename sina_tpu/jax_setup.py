"""JAX runtime configuration: the persistent compilation cache and the
compile listeners behind bench.py's compile counters.

Imported by the pipeline/bench entry points before any jit executes.
"""

from __future__ import annotations

import os
from pathlib import Path

_done = False

# the cache directory when JAX_COMPILATION_CACHE_DIR is unset: a fixed
# path, since the directory is part of every cache key
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when it is set, else the checkout's
    .jax_cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_CACHE_DIR
    )


def setup_jax() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax

    # with JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and no
    # directory is configured here
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            DEFAULT_CACHE_DIR.mkdir(exist_ok=True)
        except OSError:  # read-only checkout: run without the cache
            pass
        else:
            jax.config.update(
                "jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR)
            )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _register_compile_listener()


_after_warmup = False


def mark_warmup_done() -> None:
    """Called by the pipeline/bench once steady state is reached:
    any backend compile after this point is a shape-bucket drift
    (the '1 seq/s because a kernel recompiled mid-run' failure
    mode) and is logged loudly instead of silently eating minutes."""
    global _after_warmup
    _after_warmup = True


def warmed_up() -> bool:
    return _after_warmup


_cache_hits = 0
_cache_misses = 0
_midrun_compiles = 0
_midrun_compile_secs = 0.0


def midrun_compile_stats() -> tuple[int, float]:
    """(count, total seconds) of backend compiles seen AFTER
    mark_warmup_done().  One shape-bucket compile landing in a short
    timed phase can dominate it — bench.py puts this in its JSON line
    so a poisoned capture identifies itself."""
    return _midrun_compiles, _midrun_compile_secs


def cache_stats() -> tuple[int, int]:
    """(persistent-compile-cache hits, misses) seen this process.

    These counters make a drifting cache key visible: bench.py prints
    them in its tail, and tests/test_jax_setup.py asserts a second
    process hits."""
    return _cache_hits, _cache_misses


def _register_compile_listener() -> None:
    import logging

    import jax.monitoring

    log = logging.getLogger("sina.jax")

    def on_event(name: str, dur: float, **kw) -> None:
        if not name.endswith("backend_compile_duration"):
            return
        if _after_warmup:
            global _midrun_compiles, _midrun_compile_secs
            _midrun_compiles += 1
            _midrun_compile_secs += dur
            log.warning(
                "mid-run XLA compile took %.1fs — a new kernel "
                "shape bucket was hit after warmup (check batch/"
                "width bucketing if this repeats)", dur,
            )
        elif dur >= 5.0:
            log.info("XLA compile: %.1fs (warmup)", dur)

    jax.monitoring.register_event_duration_secs_listener(on_event)

    def on_named(name: str, **kw) -> None:
        global _cache_hits, _cache_misses
        if name == "/jax/compilation_cache/cache_hits":
            _cache_hits += 1
        elif name == "/jax/compilation_cache/cache_misses":
            _cache_misses += 1

    jax.monitoring.register_event_listener(on_named)
