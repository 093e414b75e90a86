"""jax_setup: where the persistent compilation cache lives, and that a
second process hits it."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# Runs setup_jax in a fresh process, compiles one program with the
# cache's size threshold at 0, and reports the configured directory,
# the compile-cache counters, and the files each candidate directory
# holds afterwards.
_SCRIPT = r"""
import json, os, sys
import jax
from sina_tpu import jax_setup
jax_setup.setup_jax()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
import jax.numpy as jnp
f = jax.jit(lambda x: jnp.tanh(x @ x.T).sum())
f(jnp.ones((128, 97), jnp.float32)).block_until_ready()
print(json.dumps({
    "configured": jax.config.jax_compilation_cache_dir,
    "cache_dir": jax_setup.cache_dir(),
    "stats": jax_setup.cache_stats(),
}))
"""


def _run(env_cache: str | None, home: Path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    env["HOME"] = str(home)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_cache is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_cache
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_default_cache_dir_is_the_checkouts(monkeypatch):
    from sina_tpu import jax_setup

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jax_setup.DEFAULT_CACHE_DIR == REPO / ".jax_cache"
    assert jax_setup.cache_dir() == str(REPO / ".jax_cache")


def test_env_cache_dir_wins(monkeypatch, tmp_path):
    from sina_tpu import jax_setup

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax_setup.cache_dir() == str(tmp_path)


def test_env_cache_dir_is_the_only_one_used(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there
    and nowhere else: not in $HOME, not in the checkout's default."""
    cache = tmp_path / "cache"
    home = tmp_path / "home"
    home.mkdir()
    before = set(os.listdir(REPO / ".jax_cache")) if (
        REPO / ".jax_cache"
    ).exists() else set()
    got = _run(str(cache), home)
    assert got["configured"] == str(cache)
    assert got["cache_dir"] == str(cache)
    assert got["stats"][1] >= 1  # a miss wrote an entry
    assert any(cache.iterdir())
    assert not any(home.iterdir())
    after = set(os.listdir(REPO / ".jax_cache")) if (
        REPO / ".jax_cache"
    ).exists() else set()
    assert after == before


def test_persistent_cache_hits_in_fresh_process(tmp_path):
    """A second process must hit the persistent compile cache for the
    same jit: the cache key may not drift across processes."""
    cache = str(tmp_path / "cache")
    hits1, misses1 = _run(cache, tmp_path)["stats"]
    assert misses1 >= 1  # cold cache compiles
    assert hits1 == 0
    hits2, misses2 = _run(cache, tmp_path)["stats"]
    assert hits2 >= 1, (
        "second process missed the persistent compile cache "
        f"(hits={hits2} misses={misses2}) — cache key drifts "
        "across processes"
    )
