"""Test configuration: CPU backend with a virtual 8-device mesh and x64.

Multi-device behaviour is validated on a virtual CPU mesh
(``--xla_force_host_platform_device_count=8``).  x64 is enabled so golden
comparisons against scipy run at full precision; the GPU path is f32 and is
exercised on the card by ``chip_smoke.py``.  Tests marked ``gpu`` need the
card and skip elsewhere (decided in the ``gpu`` fixture, never at import).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
