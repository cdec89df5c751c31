"""Test configuration: CPU backend, 8 virtual devices, fp64 enabled.

The reference tests N-way parallelism on however many local GPUs exist
(SURVEY.md §4.6); we do better: an 8-device virtual CPU mesh
(``--xla_force_host_platform_device_count``) exercises the real ``shard_map``
+ ``ppermute`` + ``psum`` code paths with no accelerator at all, and fp64 is
enabled so the oracle comparisons run at the reference's native precision.

The backend is the CPU unless ``JAX_PLATFORMS`` names another.  Tests that
need a GPU carry the ``gpu`` marker and the ``gpu_devices`` fixture, which
skips them on the CPU; on a machine with a card they run with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.  Their work is also a
phase of ``chip_smoke.py``.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "true")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


def pytest_report_header(config):
    return f"jax devices: {jax.device_count()} x {jax.devices()[0].platform}"


@pytest.fixture
def gpu_devices():
    """The GPU devices, or a skip: decided when the test runs, never at
    import (workers that collect different tests make the run count 0)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's backend here is {devices[0].platform!r}")
    return devices
