"""Sampled requests under preemption, on the port's continuous engine and
the JAX engine: tests/test_scheduling.py's acceptance scenario (a free-list
paged engine, the priority scheduler; two 20-token requests, the second
sampled at T 0.8 with seed 3, hold both slots; after 5 steps two urgent
3-token requests arrive and force preemptions), under
`preemption="recompute"` and `"swap"`.

A re-admission never draws again: recompute replays the retained tokens,
swap-in uploads the exact cache, and the next regular step draws at the
request's own counter.  So each long request's tokens equal the port's
uncontended run, and every request's tokens equal the JAX engine's (op by
op, `jax.disable_jit()`, under `jax.threefry_partitionable(True)`).
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
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import (ContinuousEngine, PreemptedEvent, Request, SamplingParams,
                                 ServeConfig, SwappedEvent)
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
LEVERS = ("recompute", "swap")


def _scfg(kind, preemption):
    return kind(batch_size=2, prompt_len=32, max_new_tokens=20, backend="paged", page_size=8,
                page_allocator="freelist", pool_fraction=1.0, scheduler="priority",
                preemption=preemption)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=(32,)).astype(np.int32) for _ in range(4)]


def _longs(request, sampling, prompts):
    return [request(tokens=prompts[0], max_new_tokens=20),
            request(tokens=prompts[1], max_new_tokens=20,
                    sampling=sampling(temperature=0.8, seed=3))]


def _contended(eng, request, sampling, prompts):
    """-> (tokens of the two longs and the two shorts, the events)."""
    ids = [eng.submit(r) for r in _longs(request, sampling, prompts)]
    events = []
    for _ in range(5):
        events += eng.step()
    ids += [eng.submit(request(tokens=prompts[2 + i], max_new_tokens=3, priority=2))
            for i in range(2)]
    while eng.pending:
        events += eng.step()
        eng._alloc.check_invariants()
    return [eng.result(r).tokens.tolist() for r in ids], events


@pytest.fixture(scope="module")
def runs():
    jcfg = jconfigs.get_arch("yi-6b", smoke=True)
    jccfg = dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8)
    jparams = jregistry.materialize_params(jcfg, seed=0)
    prompts = _prompts(jcfg.vocab)
    reference = {}
    with jax.threefry_partitionable(True), jax.disable_jit():
        for lever in LEVERS:
            eng = JContinuousEngine(jcfg, jccfg, _scfg(JServeConfig, lever), jparams)
            reference[lever] = _contended(eng, JRequest, JSamplingParams, prompts)[0]
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(jax.device_get(jparams), cfg, device="cpu")

    def make(lever, capture=True):
        return ContinuousEngine(cfg, ccfg, _scfg(ServeConfig, lever), params, device="cpu",
                                capture=capture)

    eng = make("recompute")
    ids = [eng.submit(r) for r in _longs(Request, SamplingParams, prompts)]
    eng.run()
    uncontended = [eng.result(r).tokens.tolist() for r in ids]
    eng = make("recompute")
    rid = eng.submit(Request(tokens=prompts[1], max_new_tokens=20))
    greedy = eng.run()[rid].tokens.tolist()
    port = {(lever, capture): _contended(make(lever, capture), Request, SamplingParams, prompts)
            for lever in LEVERS for capture in (True, False)}
    return {"reference": reference, "uncontended": uncontended, "greedy": greedy, "port": port}


@pytest.mark.parametrize("capture", [True, False], ids=["static", "eager"])
@pytest.mark.parametrize("lever", LEVERS)
def test_preempted_sampled_request_keeps_its_tokens(runs, lever, capture):
    tokens, events = runs["port"][(lever, capture)]
    longs = {e.request_id for e in events
             if isinstance(e, (PreemptedEvent, SwappedEvent))}
    assert longs, "the scenario must evict a running request"
    if lever == "swap":
        dirs = [e.direction for e in events if isinstance(e, SwappedEvent)]
        assert "out" in dirs and "in" in dirs, dirs
    assert tokens[:2] == runs["uncontended"]
    assert [len(t) for t in tokens] == [20, 20, 3, 3]


@pytest.mark.parametrize("lever", LEVERS)
def test_preemption_tokens_equal_reference(runs, lever):
    """Every request's tokens, the sampled long's included, equal the JAX
    engine's under the same lever."""
    assert runs["port"][(lever, True)][0] == runs["reference"][lever]


def test_sampled_long_is_sampled(runs):
    """The sampled long's tokens are not its prompt's greedy tokens."""
    assert runs["uncontended"][1] != runs["greedy"]
