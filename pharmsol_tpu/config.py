"""Global numeric and backend configuration for pharmsol.

The reference engine (LAPKB/pharmsol) computes everything in f64. The
working dtype here is configurable:

- the default is float64 on every backend (the GPU runs f64 natively),
- ``PHARMSOL_TPU_F32=1`` or :func:`set_float_dtype` selects float32.

All array-construction sites in the package must use :func:`float_dtype`.
Backend-dependent choices read :func:`backend_platform`, the one place that
asks JAX which platform it runs on.
"""

from __future__ import annotations

import os

import jax

# Enable 64-bit *availability*. This does not force f64 computation; it only
# allows it. The working dtype below decides what the engine actually uses.
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402  (after the config update)

# PHARMSOL_TPU_F32=1 forces f32 everywhere; otherwise f64.
_FLOAT_DTYPE = (
    jnp.float32 if os.environ.get("PHARMSOL_TPU_F32", "0") == "1"
    else jnp.float64
)

# Sentinel used for padded event times: sorts after any real time but stays
# finite so arithmetic on padded rows never produces NaN/Inf.
BIG_TIME = 1e30


def set_float_dtype(dtype) -> None:
    """Set the working float dtype (float32 or float64)."""
    global _FLOAT_DTYPE
    dtype = jnp.dtype(dtype)
    if dtype not in (jnp.dtype(jnp.float32), jnp.dtype(jnp.float64)):
        raise ValueError(f"unsupported float dtype {dtype}; use float32 or float64")
    _FLOAT_DTYPE = dtype


def float_dtype():
    """The working float dtype for engine arrays (float64 unless overridden
    by :func:`set_float_dtype` or ``PHARMSOL_TPU_F32=1``)."""
    return _FLOAT_DTYPE


def backend_platform() -> str:
    """Platform of JAX's default backend: ``"gpu"`` or ``"cpu"``.

    Every backend-dependent choice in the package (kernel interpret mode,
    the psi engine crossover) goes through this function.
    """
    return jax.default_backend()


def int_dtype():
    return jnp.int32


_COMPILATION_CACHE_DIR = None
# the fixed fallback cache directory: <repo>/.jax_cache (listed in
# .gitignore). A fixed path matters: it is part of the cache key.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compilation_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache for this process.

    The cache lives in :func:`compilation_cache_dir`; no other directory is
    ever set. Returns the directory in use. Idempotent; safe to call before
    or after backend initialization.
    """
    global _COMPILATION_CACHE_DIR
    path = os.path.abspath(compilation_cache_dir())
    if _COMPILATION_CACHE_DIR == path:
        return path
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # cache every program (the default only caches compiles >1s): the psi
    # programs that matter are past that, but benches reuse small ones too
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _COMPILATION_CACHE_DIR = path
    return path
