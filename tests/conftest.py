"""Shared fixtures. NOTE: no XLA_FLAGS here — unit tests see ONE device;
multi-device coverage runs via subprocess scripts in tests/distributed/."""
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without one")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)
