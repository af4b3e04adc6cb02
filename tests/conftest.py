"""Test configuration: an 8-device virtual CPU platform, so the multi-device
sharding logic (parallel/) is exercised without a GPU host (SURVEY.md §4:
multi-device tests via virtual host devices).

Tests that only a GPU can run carry the `gpu` marker and skip elsewhere;
they decide inside the test whether a card is present.  Run them on a GPU
machine with `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.
"""

import os

import jax
import numpy as np
import pytest

from qtesla_ntt.utils.cache import enable_compile_cache

if os.environ.get("JAX_PLATFORMS") != "cuda":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
enable_compile_cache()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xA1CE)


@pytest.fixture
def gpu():
    """The default device if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev
