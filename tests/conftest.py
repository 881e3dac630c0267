# Shared fixtures. NOTE: no XLA_FLAGS here — tests must see the real single
# CPU device; multi-device tests spawn subprocesses (test_distributed.py).

import numpy as np
import pytest

import jax


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.key(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card and nvcc; skips without them "
        "(on a card: python -m pytest --noconftest tests/test_torch_cuda.py)",
    )
