"""Test fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see the 1 real CPU device (dry-run isolation rule); multi-device semantics
are tested via subprocess in test_multidevice.py."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels); skips without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
