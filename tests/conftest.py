"""Test configuration: a virtual 8-device CPU mesh with float64.

Tests run on the CPU unless ``JAX_PLATFORMS`` says otherwise. Tests marked
``gpu`` compile the Triton kernels and skip without a card; on a GPU host
run them with ``python -m pytest -m gpu tests/`` and JAX_PLATFORMS unset.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, at test time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: compiled Triton kernels have no CPU path "
                    "(chip_smoke.py runs these checks on the card)")
