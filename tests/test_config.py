"""Compile-cache directory resolution and the working dtype default."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp

from pharmsol_tpu import config

ROOT = Path(__file__).resolve().parent.parent


def test_cache_dir_defaults_to_repo_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert config.compilation_cache_dir() == str(ROOT / ".jax_cache")


def test_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert config.compilation_cache_dir() == str(tmp_path / "c")


def test_enable_compilation_cache_writes_only_where_asked(tmp_path):
    cache = tmp_path / "cache"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from pharmsol_tpu.config import enable_compilation_cache\n"
        "print(enable_compilation_cache())\n"
        "jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.ones(7)).block_until_ready()\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache),
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(cache)
    assert any(cache.iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cache"]


def test_working_dtype_is_float64_by_default():
    assert config.float_dtype() == jnp.float64
