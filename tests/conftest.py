"""Test configuration: CPU backend with an 8-device virtual mesh.

Parity tests need f64 and fast compiles, so they run on the CPU even on a
machine with a GPU; fused kernels run there in Pallas interpret mode.
Sharding correctness is validated on a virtual 8-device CPU mesh, as
``__graft_entry__.dryrun_multichip`` does. Tests that need the GPU carry
the ``gpu`` marker and skip here (the ``gpu`` fixture decides); run them on
a GPU machine with ``PHARMSOL_TEST_GPU=1 python -m pytest -m gpu tests/``.

Note: pytest plugins import jax before this conftest runs, so setting the
environment variable alone is not enough — we also update jax.config, which
works as long as no backend has been initialized yet.
"""

import os

import pytest

_ON_GPU = os.environ.get("PHARMSOL_TEST_GPU") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX's backend has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with PHARMSOL_TEST_GPU=1 on a GPU "
                    "machine)")
    return dev
