"""The engines' step factories and their static buffers (`repro_torch.launch.steps`),
against the JAX package's engines and against the port's eager path.

On the CPU the decode steps run eagerly against the same static buffers
that a CUDA graph replays on the card: the static cache tree, the lockstep
token and the continuous step's staged rows, with every eager operation's
result copied in (`adopt`).  That bookkeeping is what is held here, on
yi-6b smoke (zipcache, fp_window 8, recompress interval 8: a probe step
and a fold inside 12 tokens), for the mixed, paged-gather and paged-kernel
layouts (parity contract d):

  * greedy tokens equal the JAX engines' (contract c), the JAX engines run
    op by op as in tests/test_torch_slice.py and tests/test_torch_continuous.py;
  * tokens and every step's logits are bitwise those of the port's eager
    path (`capture=False`: the plain functions, fresh caches every step);
  * the static tree keeps every leaf's address for the whole run, as a
    captured graph needs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import CompressionConfig as JCompression
from repro.models import registry as jregistry
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs, convert
from repro_torch.core import kvcache as kvc
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import (ContinuousEngine, Request, ServeConfig, ServingEngine,
                                 pack_requests, probe_flag)
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
BATCH, PROMPT, MAX_NEW, INTERVAL = 2, 48, 12, 8
PROMPTS = (48, 30, 41)   # the continuous scenario's ragged prompts
LOCKSTEP = {"mixed": dict(backend="mixed"),
            "paged": dict(backend="paged", page_size=8),
            "paged-kernel": dict(backend="paged", page_size=8, paged_kernel=True)}
CONTINUOUS = {"mixed": dict(backend="mixed"),
              "paged": dict(backend="paged"),
              "paged-kernel": dict(backend="paged", page_allocator="freelist",
                                   pool_fraction=0.75, paged_kernel=True)}


def _batch(vocab):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab, size=(PROMPT,)).astype(np.int32) for _ in range(BATCH)]
    return {"tokens": pack_requests(prompts, BATCH, PROMPT)}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=(n,)).astype(np.int32) for n in PROMPTS]


def _scenario(eng, request, prompts):
    """tests/test_torch_continuous.py's: a short request retiring after 6
    tokens, a third submitted mid-run into the freed slot -> outputs."""
    r0 = eng.submit(request(tokens=prompts[0]))
    r1 = eng.submit(request(tokens=prompts[1], max_new_tokens=6))
    for _ in range(4):
        eng.step()
    r2 = eng.submit(request(tokens=prompts[2]))
    res = eng.run()
    return [(res[r].tokens.tolist(), res[r].finish_reason) for r in (r0, r1, r2)]


@pytest.fixture(scope="module")
def reference():
    """The JAX engines' greedy tokens: lockstep and continuous (mixed; the
    layouts give the same tokens, tests/test_backend_conformance.py)."""
    cfg = jconfigs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(JCompression.zipcache(), fp_window=8,
                               recompress_interval=INTERVAL)
    params = jregistry.materialize_params(cfg, seed=0)
    out = {"params": jax.device_get(params)}
    with jax.disable_jit():
        eng = JServingEngine(cfg, ccfg, JServeConfig(BATCH, PROMPT, MAX_NEW), params)
        out["lockstep"] = eng.generate(_batch(cfg.vocab))["tokens"]
        scfg = JServeConfig(batch_size=2, prompt_len=48, max_new_tokens=MAX_NEW, page_size=8)
        out["continuous"] = _scenario(JContinuousEngine(cfg, ccfg, scfg, params), JRequest,
                                      _prompts(cfg.vocab))
    return out


class _Recorder:
    """A decode step that keeps a copy of every step's logits."""

    def __init__(self, step):
        self.step = step
        self.logits = []

    def __call__(self, *args):
        logits, caches = self.step(*args)
        self.logits.append(logits.clone())
        return logits, caches

    def __getattr__(self, name):
        return getattr(self.step, name)


def _addresses(caches):
    return [t.data_ptr() for g in caches["groups"] for t in kvc.tree_leaves(g["sub0"])]


@pytest.fixture(scope="module")
def port(reference):
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8,
                               recompress_interval=INTERVAL)
    params = convert.from_jax_params(reference["params"], cfg, device="cpu")
    runs = {}
    for name, kw in LOCKSTEP.items():
        for capture in (True, False):
            eng = ServingEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, MAX_NEW, **kw), params,
                                device="cpu", capture=capture)
            eng._decode = _Recorder(eng._decode)
            tokens = eng.generate(_batch(cfg.vocab))["tokens"]
            runs["lockstep", name, capture] = (eng, tokens)
    for name, kw in CONTINUOUS.items():
        for capture in (True, False):
            scfg = ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=MAX_NEW, page_size=8,
                               **kw)
            eng = ContinuousEngine(cfg, ccfg, scfg, params, device="cpu", capture=capture)
            eng._decode_masked = _Recorder(eng._decode_masked)
            before = _addresses(eng.caches)
            outs = _scenario(eng, Request, _prompts(cfg.vocab))
            runs["continuous", name, capture] = (eng, outs, before)
    return runs


@pytest.mark.parametrize("layout", list(LOCKSTEP))
def test_lockstep_tokens_match_reference(reference, port, layout):
    np.testing.assert_array_equal(port["lockstep", layout, True][1], reference["lockstep"])


@pytest.mark.parametrize("layout", list(LOCKSTEP))
def test_lockstep_static_route_is_bitwise_eager(port, layout):
    (eng, tokens), (eager, want) = port["lockstep", layout, True], port["lockstep", layout, False]
    np.testing.assert_array_equal(tokens, want)
    got, ref = eng._decode.logits, eager._decode.logits
    assert len(got) == len(ref) == MAX_NEW
    for a, w in zip(got, ref):
        assert torch.equal(a, w)
    # probe steps ran eagerly between the static steps, and a fold (MAX_NEW > INTERVAL)
    step = eng._decode.step
    n_probe = sum(probe_flag(i, INTERVAL) for i in range(MAX_NEW))
    assert n_probe > 0 and MAX_NEW > INTERVAL
    assert (step.captures, step.replays) == (1, MAX_NEW - n_probe)
    assert eng.last_caches is step.caches and eager._decode.step.caches is None


@pytest.mark.parametrize("layout", list(LOCKSTEP))
def test_lockstep_static_tree_keeps_its_addresses(port, layout):
    """A second batch on the same engine: prefill and folds are copied into
    the static tree; no leaf moves and nothing is built again."""
    eng = port["lockstep", layout, True][0]
    step = eng._decode.step
    before = _addresses(step.caches)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, eng.cfg.vocab, size=(PROMPT,)).astype(np.int32)
               for _ in range(BATCH)]
    eng.generate({"tokens": pack_requests(prompts, BATCH, PROMPT)})
    assert _addresses(step.caches) == before
    assert step.captures == 1


@pytest.mark.parametrize("variant", list(CONTINUOUS))
def test_continuous_tokens_match_reference(reference, port, variant):
    assert port["continuous", variant, True][1] == reference["continuous"]


@pytest.mark.parametrize("variant", list(CONTINUOUS))
def test_continuous_static_route_is_bitwise_eager(port, variant):
    (eng, outs, before), (eager, want, _) = (port["continuous", variant, True],
                                             port["continuous", variant, False])
    assert outs == want
    got, ref = eng._decode_masked.logits, eager._decode_masked.logits
    assert len(got) == len(ref)
    for a, w in zip(got, ref):
        assert torch.equal(a, w)
    step = eng._decode_masked.step
    # a probe step and a fold ran eagerly between the static steps
    assert step.captures == 1 and 0 < step.replays < len(got)
    assert eng._n_folds >= 1
    assert eng.caches is step.caches and _addresses(eng.caches) == before
