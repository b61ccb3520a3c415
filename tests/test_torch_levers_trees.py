"""The serving levers and the baselines on the dense trees beyond yi-6b:
the g = 7 variant of qwen2-7b's smoke config (7 / 1 heads, head dim 16,
random QKV biases) and smollm-360m's (g = 3), held to the JAX engines on
the same parameters (`tests/levers_reference.py`, jitted in child
processes).

  * The continuous engine over the paged free list, the conformance
    fixture's scenarios: the precision map ("default=k8v8;layer:1-=k3v3"),
    swap pressure under the map (a swap-out and a swap-in fire), shared-
    prefix dedup on one prompt (hits and copy-on-write copies fire) and
    ladder pressure under the map (downshifts fire).  Tokens, finish
    reasons, every event and the JAX keys of `pool_stats()` equal the JAX
    engine's; `cache_bytes` with both slots live equal the JAX engine's
    integers.  The downshift ladder armed as the preemption policy never
    fires in the map's scenario: its run equals the JAX engine's mapped run.
  * The baselines: fp16, h2o, mikv, gear and kivi on the lockstep engine
    (tokens and `cache_bytes` equal), fp16 and kivi on the continuous
    engine, the port's paged static layout and its free list (the walk on)
    against the JAX paged static layout (its free list cannot admit a
    zero-capacity store: ROADMAP.md §3).
  * Each lever's static-buffer decode step (what a replay reads on the
    card) bitwise the eager step, step by step, through its events.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.core import backend as backend_lib
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import ContinuousEngine, Request, SamplingParams, ServeConfig, ServingEngine
from tests import levers_reference as lr
from tests.levers_reference import G7, SMOL
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
ARCHS = (G7, SMOL)
LEVERS = ("pmap", "swap", "prefix", "ladder")


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    jobs = [f"{a}/{part}" for a in ARCHS for part in (",".join(LEVERS), "baselines")]
    return lr.run(tmp_path_factory.mktemp("levers") / "refs.pkl", [[j] for j in jobs])


def _port(refs, arch):
    cfg = lr.smoke(configs, arch)
    return cfg, convert.from_jax_params(refs[arch]["params"], cfg, device="cpu")


def _maker(cfg, params, policy="zipcache", capture=False, wrap=None):
    def make(kw):
        eng = ContinuousEngine(cfg, lr.ccfg(CompressionConfig, policy), ServeConfig(**kw), params,
                               device="cpu", capture=capture)
        if wrap is not None:
            eng._decode_masked = wrap(eng._decode_masked)
        return eng
    return make


def _lever(refs, arch, lever, **kw):
    cfg, params = _port(refs, arch)
    return lr.lever_run(lever, _maker(cfg, params, **kw), Request, SamplingParams,
                        backend_lib.cache_bytes, lr.prompts(cfg.vocab))


def _kinds(run):
    return [e["kind"] for e in run["events"] if e["kind"] != "TokenEvent"]


def _same_stats(got, want):
    """The JAX keys of `pool_stats()` equal; every page back but those the
    prefix index holds."""
    assert {k: got[k] for k in lr.STAT_KEYS if k in want} == \
        {k: want[k] for k in lr.STAT_KEYS if k in want}
    if not got["prefix"]["entries"]:
        assert all(got[seg]["used"] == 0 for seg in ("hi", "lo", "win"))


@pytest.mark.parametrize("lever", LEVERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_levers_match_reference(refs, arch, lever):
    got, want = _lever(refs, arch, lever), refs[arch][lever]
    assert got["outs"] == want["outs"]
    assert got["events"] == want["events"]
    _same_stats(got["stats"], want["stats"])
    assert got["bytes"] == want["bytes"]
    st, kinds = got["stats"], _kinds(got)
    if lever == "swap":
        assert kinds.count("SwappedEvent") == 2 and "PreemptedEvent" not in kinds
        assert st["swap"]["swaps_in"] == st["swap"]["swaps_out"] == 1
        assert st["swap"]["host_bytes"] == 0 and st["swap"]["entry_bytes"] > 0
    if lever == "prefix":
        assert st["prefix"]["hits"] >= 1 and st["prefix"]["cow_copies"] >= 1
        assert st["prefix"]["prefill_tokens_skipped"] == 24 * st["prefix"]["hits"]
    if lever == "ladder":
        assert st["downshift"]["downshifts"] >= 1 and st["downshift"]["pages_freed"] >= 1
    if lever in ("pmap", "swap"):
        assert got["bytes"]["packed_bytes"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_the_map_bites_and_armed_downshift_equals_it(refs, arch):
    """The downshift ladder armed as the preemption policy over the mapped
    scenario never fires (every fold still runs through the rung-taking
    programs, at rung 0): every token, event and count equals the JAX
    engine's mapped run.  And the map bites: the unmapped run's tokens
    differ (the ceilings live inside the same containers, so its bytes do
    not)."""
    got, want = _lever(refs, arch, "downshift"), refs[arch]["pmap"]
    assert got["outs"] == want["outs"] and got["events"] == want["events"]
    assert got["stats"]["downshift"] == {"downshifts": 0, "pages_freed": 0, "refusals": 0}
    cfg, params = _port(refs, arch)
    plain = lr.conformance_run(_maker(cfg, params), Request, backend_lib.cache_bytes,
                               lr.prompts(cfg.vocab), lr.FREELIST)
    assert plain["outs"] != want["outs"]
    assert plain["bytes"] == want["bytes"]


# ---- the baselines ------------------------------------------------------------------

@pytest.mark.parametrize("policy", lr.LOCKSTEP_POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_baselines_match_reference(refs, arch, policy):
    cfg, params = _port(refs, arch)
    eng = ServingEngine(cfg, lr.ccfg(CompressionConfig, policy),
                        ServeConfig(lr.LOCK_BATCH, lr.LOCK_PROMPT, lr.MAX_NEW), params, device="cpu")
    tokens, nbytes = refs[arch][f"lockstep-{policy}"]
    np.testing.assert_array_equal(eng.generate(lr.lock_batch(cfg.vocab))["tokens"], tokens)
    assert eng.cache_bytes(eng.last_caches) == nbytes


@pytest.mark.parametrize("layout", ["paged-static", "freelist-walk"])
@pytest.mark.parametrize("policy", lr.CONTINUOUS_POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_baselines_match_reference(refs, arch, policy, layout):
    cfg, params = _port(refs, arch)
    kw = lr.PAGED_STATIC if layout == "paged-static" else dict(lr.FREELIST, paged_kernel=True)
    got = lr.conformance_run(_maker(cfg, params, policy), Request, backend_lib.cache_bytes,
                             lr.prompts(cfg.vocab), kw)
    want = refs[arch][f"continuous-{policy}"]
    assert got["outs"] == want["outs"] and got["events"] == want["events"]
    if layout == "paged-static":
        assert got["bytes"] == want["bytes"]
    else:
        assert all(got["stats"][seg]["used"] == 0 for seg in ("hi", "lo", "win"))


# ---- the static-buffer step against eager -------------------------------------------

class _Logits:
    """A continuous decode step that keeps the active rows' logits of every
    call."""

    def __init__(self, step):
        self.step, self.logits = step, []

    def __call__(self, params, caches, staged):
        logits, caches = self.step(params, caches, staged)
        self.logits.append(logits[np.flatnonzero(staged[2]).tolist()].clone())
        return logits, caches

    def __getattr__(self, name):
        return getattr(self.step, name)


@pytest.mark.parametrize("lever", ["swap", "prefix", "ladder"])
@pytest.mark.parametrize("arch", ARCHS)
def test_static_buffer_steps_equal_eager_through_levers(refs, arch, lever):
    """The decode step over its static cache tree against `capture=False`,
    with the page walk, step by step through swap-in, alias admissions and
    copy-on-write copies, or downshift folds: a restore, an alias or an
    early fold that left a static leaf stale would show in the steps after
    it."""
    got = []
    for capture in (False, True):
        recs = []

        def wrap(step):
            recs.append(_Logits(step))
            return recs[-1]

        cfg, params = _port(refs, arch)
        make = _maker(cfg, params, capture=capture, wrap=wrap)
        run = lr.lever_run(lever, lambda kw: make(dict(kw, paged_kernel=True)), Request,
                           SamplingParams, backend_lib.cache_bytes, lr.prompts(cfg.vocab))
        got.append((run, recs[0]))
    (eager, e_rec), (static, s_rec) = got
    assert static["outs"] == eager["outs"] == refs[arch][lever]["outs"]
    assert s_rec.captures == 1 and s_rec.replays > 0 and e_rec.captures == 0
    assert len(s_rec.logits) == len(e_rec.logits) > 0
    for a, w in zip(s_rec.logits, e_rec.logits):
        assert torch.equal(a, w)
