"""Shared test config.  NOTE: no XLA_FLAGS here by design — smoke tests and
benches must see the single real device; only launch/dryrun.py forces 512
placeholder devices (and it does so before any jax import)."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: slow Pallas interpret-mode tests "
        "(deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card; skips inside the test when none is present")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
