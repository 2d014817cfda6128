import jax
import numpy as np
import pytest

import repro.compat  # noqa: F401  — installs jax.set_mesh fallback on older JAX

# NOTE: no XLA_FLAGS here on purpose — tests must see the real single CPU
# device (the 512-device override belongs to launch/dryrun.py only).


@pytest.fixture(scope="session")
def mesh11():
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips without one"
    )
