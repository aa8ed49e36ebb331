"""Test configuration.

Tests run on the CPU backend with 8 virtual devices (they back the
multi-device sharding tests, SURVEY.md §4.3), pinned before any test module
imports jax or interpn_tpu. A CPU-pinned process sets no persistent
compilation cache (interpn_tpu/config.py).

`python -m pytest -m gpu tests/` selects the tests that need a GPU and
leaves the platform unpinned, so they run on the card. Elsewhere the
`gpu_device` fixture skips them.
"""

import jax
import pytest


def pytest_configure(config):
    if (config.getoption("markexpr", "") or "").strip() != "gpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
