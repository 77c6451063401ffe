"""Test configuration: force the CPU backend with 8 virtual devices so the
multi-device sharded paths are exercised without accelerators. Must run
before jax is imported anywhere. ``SMAFA_TEST_DEVICE=gpu`` leaves the
backend alone, for running the ``gpu``-marked tests on a card."""

import os

if os.environ.get("SMAFA_TEST_DEVICE") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    # Setting the config before any backend initializes wins over any
    # platform chosen earlier in the process.
    jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture
def data_dir() -> pathlib.Path:
    return DATA
