"""The engines' `cache_bytes` against the JAX engines' numbers, as equal
integers (packed payload, overhead, free-pool bytes, total):

  * the lockstep engine's `last_caches` after a mixed-layout generate
    (tests/test_serving.py's cache_bytes scenario: 2 prompts of 48 tokens,
    4 new tokens);
  * the continuous engine on paged-static and paged free-list at
    pool_fraction 0.75 (tests/test_page_alloc.py's `constrained_engines`:
    budgets 40/4/40/4 over 2 slots, page 8, 8-token prompts), after every
    step and on the drained engine, where the whole free-list pool is free.

The JAX engines run jitted in a child process (`tests/serving_reference.py`:
excess precision and the algebraic simplifier off, so they take the
op-by-op run's tokens).
"""

import pytest

from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import (ContinuousEngine, Request, ServeConfig, ServingEngine,
                                 pack_requests)
from tests import serving_reference as sr
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
ALLOCATORS = sr.ALLOCATORS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref = sr.run(tmp_path_factory.mktemp("cache_bytes") / "ref.pkl", "cache_bytes")
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = sr.ccfg(CompressionConfig)
    params = convert.from_jax_params(ref["params"], cfg, device="cpu")
    out = {("lockstep", "jax"): ref["lockstep"]}
    out.update({(name, "jax"): ref[name] for name in ALLOCATORS})
    out["lockstep", "port"] = sr.lockstep_bytes(
        lambda kw: ServingEngine(cfg, ccfg, ServeConfig(**kw), params, device="cpu"),
        pack_requests, cfg.vocab)
    for name, kw in ALLOCATORS.items():
        out[name, "port"] = sr.constrained_bytes(
            lambda kw_: ContinuousEngine(cfg, ccfg, ServeConfig(**kw_), params, device="cpu"),
            Request, cfg.vocab, kw)
    return out


def test_lockstep_cache_bytes_equal_reference(runs):
    got, tokens = runs["lockstep", "port"]
    want, want_tokens = runs["lockstep", "jax"]
    assert tokens == want_tokens
    assert got == want
    assert set(got) == {"packed_bytes", "overhead_bytes", "free_pool_bytes", "total_bytes"}
    assert 0 < got["packed_bytes"] < got["total_bytes"]
    assert got["packed_bytes"] + got["overhead_bytes"] == got["total_bytes"]


@pytest.mark.parametrize("allocator", list(ALLOCATORS))
def test_continuous_cache_bytes_equal_reference_every_step(runs, allocator):
    got, tokens, _ = runs[allocator, "port"]
    want, want_tokens, _ = runs[allocator, "jax"]
    assert tokens == want_tokens
    assert len(got) == len(want) > 0
    for i, (a, w) in enumerate(zip(got, want)):
        assert a == w, (i, a, w)
        assert a["packed_bytes"] + a["overhead_bytes"] == a["total_bytes"]


def test_drained_freelist_pool_is_free(runs):
    """The drained free-list engine reports its whole pool free, inside its
    overhead; the static layout has no free pool."""
    cb = runs["freelist", "port"][2]
    assert cb == runs["freelist", "jax"][2]
    assert 0 < cb["free_pool_bytes"] <= cb["overhead_bytes"]
    assert runs["static", "port"][2]["free_pool_bytes"] == 0
