"""Test configuration: force the CPU backend with an 8-device virtual mesh
so sharding tests run anywhere, enable x64 for golden-value comparisons.

The platform is pinned via jax.config before any backend is initialized;
what needs the GPU runs in chip_smoke.py (tests marked ``gpu``).
"""

import os

os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "") +
     " --xla_force_host_platform_device_count=8").strip())

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
