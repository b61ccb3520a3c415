import os

# Tests run single-device (the dry-run alone uses fake devices; see
# test_sharding.py which spawns subprocesses with its own XLA_FLAGS).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

# fixture trees for the tools/analyze self-tests contain deliberately-bad
# source (including a fake test_backend_conformance.py) — never collect them
collect_ignore = ["fixtures"]


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skips where torch sees none")
