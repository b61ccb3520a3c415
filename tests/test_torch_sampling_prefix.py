"""Sampled requests under shared-prefix dedup, on the port's continuous
engine and the JAX engine: tests/test_torch_prefix.py's shared-prompt
scenario (2 slots, four requests on one 24-token prompt, the last of
budget 4; paged free list at 1.5, page 8) with every request sampled, at
its own seed.

A hit draws its first token (counter 0) from the donor's snapshot logits
with the HIT request's seed, and writes nothing: each request's tokens
equal dedup off and the JAX engine's (op by op, `jax.disable_jit()`, under
`jax.threefry_partitionable(True)`), and the snapshot is still bitwise a
fresh prefill after the hits.
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
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import ContinuousEngine, Request, SamplingParams, ServeConfig
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
SHARED = np.arange(2, 26, dtype=np.int32)       # 24 tokens: a 3-page bucket
# (temperature, seed, budget) per request, in submission order
TRAFFIC = ((0.7, 11, 12), (1.0, 12, 12), (0.7, 13, 12), (1.0, -5, 4))


def _run(make, request, sampling, prefix_on):
    """-> (tokens per request, the prefix block of pool_stats, engine)."""
    eng = make(dict(batch_size=2, prompt_len=32, max_new_tokens=12, page_size=8,
                    backend="paged", page_allocator="freelist", pool_fraction=1.5,
                    prefix_cache=prefix_on))
    ids = [eng.submit(request(tokens=SHARED.copy(), max_new_tokens=m,
                              sampling=sampling(temperature=t, seed=s)))
           for t, s, m in TRAFFIC]
    while eng.pending:
        eng.step()
        eng._alloc.check_invariants()
    return [eng.result(r).tokens.tolist() for r in ids], eng.pool_stats()["prefix"], eng


@pytest.fixture(scope="module")
def shared():
    jcfg = jconfigs.get_arch("yi-6b", smoke=True)
    jccfg = dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8)
    jparams = jregistry.materialize_params(jcfg, seed=0)
    with jax.threefry_partitionable(True), jax.disable_jit():
        reference = _run(lambda kw: JContinuousEngine(jcfg, jccfg, JServeConfig(**kw), jparams),
                         JRequest, JSamplingParams, True)[:2]
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(jax.device_get(jparams), cfg, device="cpu")

    def make(kw, capture=True):
        return ContinuousEngine(cfg, ccfg, ServeConfig(**kw), params, device="cpu",
                                capture=capture)

    return {"reference": reference, "make": make}


@pytest.mark.parametrize("capture", [True, False], ids=["static", "eager"])
def test_hits_draw_with_their_own_seed(shared, capture):
    make = lambda kw: shared["make"](kw, capture)  # noqa: E731
    off, pf_off, _ = _run(make, Request, SamplingParams, False)
    on, pf_on, _ = _run(make, Request, SamplingParams, True)
    r_out, r_pf = shared["reference"]
    assert pf_on["hits"] >= 2 and pf_off["hits"] == 0, pf_on
    assert pf_on == r_pf
    assert [t[0] for t in on] == [t[0] for t in off] == [t[0] for t in r_out]
    assert on == off == r_out
    # one prompt, four seeds: the first tokens are not all one greedy token
    assert len({t[0] for t in on}) > 1


def test_snapshot_is_untouched_by_the_draws(shared):
    _, pf, eng = _run(shared["make"], Request, SamplingParams, True)
    assert pf["hits"] >= 2
    (_, (_, logits)), = eng._prefix_snap.items()
    with torch.inference_mode():
        want, _ = eng._prefill_for(24)(eng.params, {"tokens": torch.from_numpy(SHARED[None].copy())})
    assert torch.equal(logits, want)
