"""Port parity: probe positions (a numpy threefry port) and the salient
split (stable ties), exact against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import saliency as jsal
from repro_torch.core import saliency as sal
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

SEQ_LENS = [8, 9, 17, 48, 64, 100, 255, 512, 1000, 1024, 1500, 2047, 2048, 3001, 4096]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_select_probes_exact(seed):
    # the port implements jax's partitionable threefry mode; pin it with the
    # context manager so the comparison holds under any jax default
    with jax.threefry_partitionable(True):
        for n in SEQ_LENS:
            for strategy in ("random+recent", "random", "recent"):
                want = jsal.select_probes(n, strategy, seed=seed)
                got = sal.select_probes(n, strategy, seed=seed)
                np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions),
                                              err_msg=f"{strategy} n={n} seed={seed}")
                assert (got.n_recent, got.n_random) == (want.n_recent, want.n_random)


def test_select_probes_repeat_at_long_prompts():
    """The random half draws with replacement: repeats the kernels must handle."""
    for n, total, unique in ((1024, 102, 99), (2048, 205, 200)):
        pos = sal.select_probes(n).positions.numpy()
        assert (len(pos), len(np.unique(pos))) == (total, unique)


@pytest.mark.parametrize("n_salient", [0, 5, 17, 32])
def test_salient_split_exact(n_salient, rng):
    s = rng.uniform(size=(3, 32)).astype(np.float32)
    s[1] = 0.0                                   # a row of ties
    s[2, ::3] = 0.5                              # partial ties
    ws, wr = jsal.salient_split(jnp.asarray(s), n_salient)
    gs, gr = sal.salient_split(torch.from_numpy(s), n_salient)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
