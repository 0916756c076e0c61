"""The persistent compile cache lands in $JAX_COMPILATION_CACHE_DIR when it
is set, else in <checkout>/.jax_cache (one helper for every entry point)."""

import os
import subprocess
import sys
import textwrap

import pytest

from deeparc_tpu.utils.compile_cache import (
    CHECKOUT_ROOT, compile_cache_dir, enable_compile_cache,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dir_unset_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert CHECKOUT_ROOT == REPO
    assert compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_dir_set_is_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_enable_sets_jax_config(monkeypatch, tmp_path):
    import jax

    old = jax.config.jax_compilation_cache_dir
    old_t = jax.config.jax_persistent_cache_min_compile_time_secs
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert enable_compile_cache(min_compile_secs=0.7) == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.7
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", old_t)


_PROBE = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    from deeparc_tpu.utils.compile_cache import enable_compile_cache
    print(enable_compile_cache(min_compile_secs=0.0, min_entry_bytes=-1))
    c = float(sys.argv[1])
    jax.jit(lambda x: x * c + 1.0)(jax.numpy.ones(3)).block_until_ready()
""")


def _entries(path):
    return set(os.listdir(path)) if os.path.isdir(path) else set()


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_entries_land_there(tmp_path, env_set):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    want = str(tmp_path / "cache") if env_set else os.path.join(
        REPO, ".jax_cache")
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    before = _entries(want)
    # a constant unique to this run makes a fresh cache key
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, repr(os.getpid() + 0.25)],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want
    assert _entries(want) - before, "no cache entry was written"
