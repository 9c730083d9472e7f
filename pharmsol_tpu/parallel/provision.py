"""Virtual-device provisioning for multi-chip dry runs and tests.

Multi-device sharding code cannot assume the caller prepared an N-device
backend: a process on a one-GPU machine sees one device, and once a backend
is initialized in-process it cannot be swapped for a virtual CPU mesh (XLA
reads ``--xla_force_host_platform_device_count`` at client creation). The
child processes started here are CPU-only (``JAX_PLATFORMS=cpu``); they
never open the GPU.

This module centralizes the answer:

- :func:`cpu_mesh_env` — the child environment that yields an N-device
  virtual CPU backend.
- :func:`have_cpu_devices` — can the *current* process provide N CPU
  devices (i.e. the env was prepared before backend init)?
- :func:`run_in_virtual_env` — re-exec a script in a subprocess with the
  prepared environment and propagate failures.

Used by ``__graft_entry__.dryrun_multichip`` and available to examples;
``tests/conftest.py`` achieves the same effect inline because it runs
before any backend initialization.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

__all__ = ["cpu_mesh_env", "have_cpu_devices", "run_in_virtual_env"]

_FORCE_FLAG = "--xla_force_host_platform_device_count"


def cpu_mesh_env(n_devices: int, base: dict | None = None) -> dict:
    """Return an environment dict that boots jax on an N-device CPU backend.

    Any pre-existing ``xla_force_host_platform_device_count`` in XLA_FLAGS is
    replaced; ``JAX_PLATFORMS`` is pinned to cpu (read at jax import time, so
    it takes effect in a fresh process even though it is ignored once a
    backend exists).
    """
    env = dict(os.environ if base is None else base)
    flags = env.get("XLA_FLAGS", "")
    flags = re.sub(rf"{_FORCE_FLAG}=\d+", "", flags).strip()
    env["XLA_FLAGS"] = f"{flags} {_FORCE_FLAG}={n_devices}".strip()
    env["JAX_PLATFORMS"] = "cpu"
    return env


def have_cpu_devices(n_devices: int) -> bool:
    """True iff this process can already serve ``n_devices`` CPU devices.

    Returns False (never raises) when the backend is a real accelerator,
    has too few devices, or failed to initialize — all cases where the
    caller should fall back to :func:`run_in_virtual_env`.
    """
    try:
        import jax

        devs = jax.devices()
    except Exception:
        return False
    return len(devs) >= n_devices and all(
        d.platform == "cpu" for d in devs[:n_devices]
    )


def run_in_virtual_env(argv: list[str], n_devices: int, timeout: float = 1800.0) -> None:
    """Run ``python *argv`` in a subprocess with an N-device CPU backend.

    Streams output through; raises RuntimeError on nonzero exit so the
    caller's failure is loud, not swallowed.
    """
    cmd = [sys.executable, *argv]
    proc = subprocess.run(cmd, env=cpu_mesh_env(n_devices), timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"virtual-mesh subprocess failed (rc={proc.returncode}): {' '.join(cmd)}"
        )
