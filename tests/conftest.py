"""Test configuration: everything runs on the CPU with 8 virtual devices,
so the multi-device sharding paths are exercised without a GPU. Tests that
need the card carry the ``gpu`` marker and take the ``gpu_device``
fixture; here they skip, and ``python chip_smoke.py`` runs the same paths
on the card."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, decided when the test runs (never at import or
    collection, so every xdist worker collects the same tests)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU; on the card run: python chip_smoke.py")
    return devices[0]
