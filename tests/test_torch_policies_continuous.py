"""Port parity for the baseline policies on the continuous engine: greedy
tokens of `ContinuousEngine` on yi-6b smoke (fp_window 8, recompress
interval 8) equal to the JAX package's, for mikv, h2o, fp16, gear and
kivi, with the JAX parameters carried over by `convert.from_jax_params`.

Three ragged requests (24, 15 and 20 tokens: three admission buckets at
page 8) on two slots, one retiring after 5 tokens, so a slot re-admits and
windows fold on each slot's own cadence.  The port runs the paged free list
at pool_fraction 0.75 with the page walk on (fp16 and h2o walk their raw
pages; mikv, gear and kivi take the gather path), against the JAX engine
on the paged static layout: the JAX free-list allocator cannot admit a
request of a policy with a zero-capacity store (`alloc.slice_occupancy`
reshapes an empty position row, ROADMAP.md §3), and a layout's greedy
tokens are the static layout's by the layouts' contract.  kivi also runs
on the mixed layout against the JAX mixed layout: there a fold promotes
the stores to f32 (the paged slot fold casts back to the store dtype), so
the port's static-buffer step is built again mid-run.  The JAX engine runs
op by op (`jax.disable_jit()`, tests/test_torch_slice.py says why).
Requests drain through `stream()`.
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
from repro_torch import configs, convert
from repro_torch.core import paged
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import ContinuousEngine, Request, ServeConfig
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
PROMPTS, BUDGETS = (24, 15, 20), (10, 5, 10)
LAYOUTS = {"mixed": (dict(backend="mixed"), dict(backend="mixed")),
           "paged-freelist-walk": (dict(backend="paged", page_allocator="freelist",
                                        pool_fraction=0.75, paged_kernel=True),
                                   dict(backend="paged"))}
CASES = [(p, "paged-freelist-walk") for p in ("mikv", "h2o", "fp16", "gear", "kivi")] + [
    ("kivi", "mixed")]


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=(n,)).astype(np.int32) for n in PROMPTS]


def _serve(eng, request, prompts):
    rids = [eng.submit(request(tokens=p, max_new_tokens=m)) for p, m in zip(prompts, BUDGETS)]
    streams = [list(eng.stream(r)) for r in rids]
    return [eng.result(r).tokens.tolist() for r in rids], streams


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's greedy tokens under each policy and layout."""
    cfg = jconfigs.get_arch("yi-6b", smoke=True)
    params = jregistry.materialize_params(cfg, seed=0)
    out = {"params": jax.device_get(params)}
    with jax.disable_jit():
        for policy, layout in CASES:
            ccfg = dataclasses.replace(JCompression.preset(policy), fp_window=8,
                                       recompress_interval=8)
            scfg = JServeConfig(batch_size=2, prompt_len=24, max_new_tokens=10, page_size=8,
                                **LAYOUTS[layout][1])
            eng = JContinuousEngine(cfg, ccfg, scfg, params)
            out[policy, layout] = _serve(eng, JRequest, _prompts(cfg.vocab))[0]
    return out


@pytest.mark.parametrize("policy,layout", CASES)
def test_greedy_tokens_match_reference(reference, policy, layout):
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.preset(policy), fp_window=8,
                               recompress_interval=8)
    params = convert.from_jax_params(reference["params"], cfg, device="cpu")
    scfg = ServeConfig(batch_size=2, prompt_len=24, max_new_tokens=10, page_size=8,
                       **LAYOUTS[layout][0])
    eng = ContinuousEngine(cfg, ccfg, scfg, params, device="cpu")
    paged.GATHER_DECODES.launches = 0
    tokens, streams = _serve(eng, Request, _prompts(cfg.vocab))
    assert tokens == reference[policy, layout]
    assert streams == tokens
    if layout == "mixed":   # built again after the first fold's promotion
        assert eng._decode_masked.captures == 2
    else:
        eng._alloc.check_invariants()
        stats = eng.pool_stats()
        assert stats["deferrals"] >= 1 and stats["folds"] >= 1
        assert all(stats[s]["used"] == 0 for s in ("hi", "lo", "win"))
        walks = policy in ("h2o", "fp16")
        assert (paged.GATHER_DECODES.launches == 0) is walks
