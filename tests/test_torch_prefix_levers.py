"""Port parity for the levers' refusals of an aliased slot, now reachable
with shared-prefix dedup: a slot that still shares prefix pages
(`alloc.needs_privatize`) is neither swapped out nor downshifted.

  * Swap: two requests on one prompt (the second a hit), then an urgent
    one that forces a victim before either folds.  Both share their hi/lo
    pages, so the swap is refused (`refusals["aliased"]`) and the victim is
    preempted by recompute; its re-admission hits the index again.
  * Ladder: the same two requests under a watermark that holds the pools
    pressured throughout.  The ladder refuses both while they share pages
    (`note_downshift_refusal`) and downshifts them once their first fold
    gave them their own.

Each runs on the port and on the JAX engine (op by op,
`jax.disable_jit()`) with the same parameters: tokens, finish reasons,
every event and the swap, downshift and prefix blocks of `pool_stats()`
equal.  On the port alone: the swap scenario's tokens equal the same
traffic without dedup (where the swap goes through).
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
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import ContinuousEngine, Request, ServeConfig
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
SHARED = np.arange(2, 26, dtype=np.int32)
BASE = dict(batch_size=2, prompt_len=32, max_new_tokens=12, page_size=8, backend="paged",
            page_allocator="freelist", pool_fraction=1.5)


def _run(make, request, scenario, other, prefix_cache=True):
    """-> (tokens and finish reason per request, events, pool stats)."""
    if scenario == "swap":
        eng = make(dict(BASE, prefix_cache=prefix_cache, scheduler="priority",
                        preemption="swap"))
    else:
        eng = make(dict(BASE, prefix_cache=prefix_cache, ladder_watermark=0.9))
    events = []
    rids = [eng.submit(request(tokens=SHARED.copy()))]
    events += eng.step()                # admitted and registered in one pass
    rids.append(eng.submit(request(tokens=SHARED.copy())))   # a hit
    for _ in range(2):
        events += eng.step()
    if scenario == "swap":
        rids.append(eng.submit(request(tokens=other, max_new_tokens=3, priority=2)))
    while eng.pending:
        events += eng.step()
        eng._alloc.check_invariants()
    outs = [(eng.result(r).tokens.tolist(), eng.result(r).finish_reason) for r in rids]
    return outs, [dataclasses.asdict(e) | {"kind": type(e).__name__} for e in events], \
        eng.pool_stats()


@pytest.fixture(scope="module")
def runs():
    jcfg = jconfigs.get_arch("yi-6b", smoke=True)
    jccfg = dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8)
    jparams = jregistry.materialize_params(jcfg, seed=0)
    other = np.random.default_rng(0).integers(2, jcfg.vocab, size=(24,)).astype(np.int32)

    def jmake(kw):
        return JContinuousEngine(jcfg, jccfg, JServeConfig(**kw), jparams)

    with jax.disable_jit():
        reference = {s: _run(jmake, JRequest, s, other) for s in ("swap", "ladder")}
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(jax.device_get(jparams), cfg, device="cpu")

    def make(kw):
        return ContinuousEngine(cfg, ccfg, ServeConfig(**kw), params, device="cpu")

    return {"reference": reference, "make": make, "other": other}


def _kinds(events):
    return [e["kind"] for e in events if e["kind"] != "TokenEvent"]


@pytest.mark.parametrize("scenario", ["swap", "ladder"])
def test_aliased_refusal_matches_reference(runs, scenario):
    outs, events, stats = _run(runs["make"], Request, scenario, runs["other"])
    r_outs, r_events, r_stats = runs["reference"][scenario]
    assert outs == r_outs
    assert events == r_events
    for block in ("prefix", "downshift", "preemptions", "hi", "lo", "win"):
        assert stats[block] == r_stats[block], block
    assert stats["prefix"]["hits"] >= 1
    if scenario == "swap":
        assert stats["swap"] == r_stats["swap"]
        assert stats["swap"]["refusals"]["aliased"] >= 1
        assert stats["swap"]["swaps_out"] == 0 and stats["preemptions"] >= 1
        assert "PreemptedEvent" in _kinds(events) and "SwappedEvent" not in _kinds(events)
    else:
        ds = stats["downshift"]
        assert ds["refusals"] >= 1 and ds["downshifts"] >= 1, ds
        assert "DownshiftEvent" in _kinds(events)


def test_refused_swap_keeps_the_tokens_of_a_swap(runs):
    """The same traffic without dedup swaps the victim out and back; with
    dedup the refused swap falls back to recompute, and every request's
    tokens are the same."""
    out_on, _, st_on = _run(runs["make"], Request, "swap", runs["other"])
    out_off, ev_off, st_off = _run(runs["make"], Request, "swap", runs["other"],
                                   prefix_cache=False)
    assert "SwappedEvent" in _kinds(ev_off) and st_off["swap"]["swaps_out"] == 1
    assert out_on == out_off
    for st in (st_on, st_off):
        assert all(st[seg]["outstanding"] == 0 for seg in ("hi", "lo", "win"))
