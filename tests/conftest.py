"""Test configuration.

Tests run on the CPU with 8 virtual devices, so multi-device sharding
paths (jax.sharding.Mesh / shard_map) execute without accelerators.
Tests marked `gpu` need an NVIDIA GPU and skip elsewhere; run them on
the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

Must set env before jax is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first NVIDIA GPU; skips the test where there is none."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU")
    return devices[0]
