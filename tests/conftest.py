"""Test configuration: CPU with 8 virtual devices (the standard JAX way to
exercise mesh/sharding code on one host) and float64 enabled for
tolerance-based oracle comparisons.

The platform is forced to the CPU unless JAX_PLATFORMS names another
one. Tests marked `gpu` need the card; run them there with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

and they skip, with the reason, everywhere else."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)

from cfjax.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is the GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")


@pytest.fixture
def rng():
    return np.random.default_rng(42)
