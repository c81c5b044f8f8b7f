import os

# Keep the test suite on the host's device topology — the 512-device
# dry-run flag is set only when repro.launch.dryrun runs as __main__, and
# the multi-device CI leg opts in via XLA_FLAGS in the environment.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips without them")
