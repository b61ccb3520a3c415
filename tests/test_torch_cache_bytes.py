"""The engines' `cache_bytes` against the JAX engines' numbers, as equal
integers (packed payload, overhead, free-pool bytes, total):

  * the lockstep engine's `last_caches` after a mixed-layout generate
    (tests/test_serving.py's cache_bytes scenario: 2 prompts of 48 tokens,
    4 new tokens);
  * the continuous engine on paged-static and paged free-list at
    pool_fraction 0.75 (tests/test_page_alloc.py's `constrained_engines`:
    budgets 40/4/40/4 over 2 slots, page 8, 8-token prompts), after every
    step and on the drained engine, where the whole free-list pool is free.

The JAX engines run op by op (`jax.disable_jit()`).
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core.policy import CompressionConfig as JCompression
from repro.models import registry as jregistry
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import pack_requests as jpack
from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import (ContinuousEngine, Request, ServeConfig, ServingEngine,
                                 pack_requests)
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
ALLOCATORS = {"static": dict(page_allocator="static"),
              "freelist": dict(page_allocator="freelist", pool_fraction=0.75)}
BUDGETS = (40, 4, 40, 4)


def _lockstep(make, pack, vocab):
    rng = np.random.default_rng(0)
    toks = [rng.integers(2, vocab, size=(48,)).astype(np.int32) for _ in range(2)]
    eng = make(dict(batch_size=2, prompt_len=48, max_new_tokens=4))
    out = eng.generate({"tokens": pack(toks, 2, 48)})
    return eng.cache_bytes(eng.last_caches), np.asarray(out["tokens"]).tolist()


def _constrained(make, request, vocab, kw):
    """-> (cache_bytes after every step, tokens per request, drained engine's)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab, size=(8,)).astype(np.int32) for _ in range(4)]
    eng = make(dict(batch_size=2, prompt_len=8, max_new_tokens=40, backend="paged",
                    page_size=8, **kw))
    rids = [eng.submit(request(tokens=p, max_new_tokens=m)) for p, m in zip(prompts, BUDGETS)]
    per_step = []
    while eng.pending:
        eng.step()
        per_step.append(eng.cache_bytes(eng.caches))
    return per_step, [eng.result(r).tokens.tolist() for r in rids], eng


@pytest.fixture(scope="module")
def runs():
    jcfg = jconfigs.get_arch("yi-6b", smoke=True)
    jccfg = dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8)
    jparams = jregistry.materialize_params(jcfg, seed=0)
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(jax.device_get(jparams), cfg, device="cpu")
    out = {}
    with jax.disable_jit():
        out["lockstep", "jax"] = _lockstep(
            lambda kw: JServingEngine(jcfg, jccfg, JServeConfig(**kw), jparams), jpack,
            jcfg.vocab)
        for name, kw in ALLOCATORS.items():
            out[name, "jax"] = _constrained(
                lambda kw_: JContinuousEngine(jcfg, jccfg, JServeConfig(**kw_), jparams),
                JRequest, jcfg.vocab, kw)
    out["lockstep", "port"] = _lockstep(
        lambda kw: ServingEngine(cfg, ccfg, ServeConfig(**kw), params, device="cpu"),
        pack_requests, cfg.vocab)
    for name, kw in ALLOCATORS.items():
        out[name, "port"] = _constrained(
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
    got = runs["freelist", "port"][2]
    cb = got.cache_bytes(got.caches)
    assert cb == runs["freelist", "jax"][2].cache_bytes(runs["freelist", "jax"][2].caches)
    assert 0 < cb["free_pool_bytes"] <= cb["overhead_bytes"]
    static = runs["static", "port"][2]
    assert static.cache_bytes(static.caches)["free_pool_bytes"] == 0
