"""Test environment: CPU backend with 8 virtual devices (for mesh/sharding
tests, SURVEY.md section 4 anchor 5) and float64 enabled (CPU oracle accuracy,
BASELINE.md MAE target)."""

import os

# Force CPU through jax.config (re-read at backend initialization), whatever
# JAX_PLATFORMS says: the tests run on the CPU.  XLA_FLAGS is read at CPU client creation, which has not
# happened yet, so the env var still works for the virtual device count.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
