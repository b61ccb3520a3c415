"""The port's zero-rebuild steady state (port of the mixed, paged free-list,
precision-map, downshift-ladder, swap-tier and shared-prefix scenarios of
tests/test_retrace.py, and of its guard test).

The port's counterpart of a jitted program is a decode step over static
buffers (`repro_torch.launch.steps`), built once: captured as a CUDA graph
on the card, its static buffers allocated on the CPU.
`repro_torch.runtime.compile_guard` counts those builds, so the invariant
is asserted directly on the CPU:

  * warm-up (a full scenario pass) builds more than zero steps (the guard
    really sees this process);
  * a second, identically shaped pass on the SAME engine builds none,
    while a preemption (mixed), an admission deferral (paged free list), a
    downshift (the ladder) or a swap-out and swap-in (the swap tier) fires
    inside the guarded region, and under a precision map.

A step object never builds twice (a changed input shape fails in `copy_`
rather than rebuilding), so what these tests can catch is an engine that
makes new step objects in steady state; a hidden retrace forced by a
shape or a host value, which the reference's test catches under
`jax.jit`, has no counterpart here.

The mixed scenario carries the reference's sampled request (T 0.7, seed
5): a step on which a row samples draws through the step's sampler (a
second graph on the card, built once), so the whole scenario builds at
most two programs and its steady state none.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.policy import CompressionConfig
from repro_torch.core.prng import SAMPLES
from repro_torch.launch import steps as steps_lib
from repro_torch.models import registry
from repro_torch.runtime import compile_guard
from repro_torch.serving import (ContinuousEngine, PreemptedEvent, Request, SamplingParams,
                                 ServeConfig, SwappedEvent)
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
INTERVAL = 8


def _setup(policy="zipcache"):
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.preset(policy), fp_window=8,
                               recompress_interval=INTERVAL)
    return cfg, ccfg, registry.materialize_params(cfg, 0, device="cpu")


def _engine(policy="zipcache", **scfg_kw):
    cfg, ccfg, params = _setup(policy)
    scfg = ServeConfig(**{**dict(batch_size=2, prompt_len=32, max_new_tokens=12), **scfg_kw})
    return cfg, ContinuousEngine(cfg, ccfg, scfg, params, device="cpu")


def _prompts(cfg, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab, size=(24,)).astype(np.int32) for _ in range(n)]


def _drive_mixed_scenario(eng, prompts):
    """Admission, folds, retirement, a mid-run admission into a freed slot,
    and a forced preemption + recompute (a priority-2 short request arriving
    with both slots held).  Returns the events."""
    events = []
    r0 = eng.submit(Request(tokens=prompts[0]))           # max_new 12 > 8: folds
    eng.submit(Request(tokens=prompts[1], max_new_tokens=6,
                       sampling=SamplingParams(temperature=0.7, seed=5)))
    for _ in range(4):
        events += eng.step()
    eng.submit(Request(tokens=prompts[2]))                # mid-run admission
    eng.submit(Request(tokens=prompts[3], max_new_tokens=3, priority=2))
    while eng.pending:
        events += eng.step()
    assert eng.result(r0).finish_reason == "length"
    return events


def _drive_prefix_scenario(eng, shared, fresh):
    """Shared-prefix traffic: three requests on one prompt (two fold, so their
    aliased pages are copied first; one too short to fold) and one distinct
    prompt (a miss and a registration), at a 24-token bucket."""
    for _ in range(2):
        eng.submit(Request(tokens=shared.copy()))
    eng.submit(Request(tokens=shared.copy(), max_new_tokens=4))
    eng.submit(Request(tokens=fresh))
    eng.run()


def _drive_deferral_scenario(eng, prompts):
    """Admission, folds, retirement, and a watermark-forced admission
    deferral (the third request waits until the short one retires and
    returns its pages) on the free-list paged engine."""
    eng.submit(Request(tokens=prompts[0]))
    eng.submit(Request(tokens=prompts[1], max_new_tokens=6))
    for _ in range(4):
        eng.step()
    eng.submit(Request(tokens=prompts[2]))                # defers, then admits
    eng.run()


def test_mixed_engine_zero_builds_at_steady_state():
    cfg, eng = _engine(scheduler="priority", preemption="recompute")

    with compile_guard.count_captures() as warm:
        _drive_mixed_scenario(eng, _prompts(cfg, seed=0, n=4))
    assert 0 < warm.count <= 2, warm.describe()   # the decode step, its sampler

    draws = SAMPLES.launches
    with compile_guard.assert_no_captures() as steady:
        events = _drive_mixed_scenario(eng, _prompts(cfg, seed=1, n=4))
    assert steady.count == 0
    assert any(isinstance(e, PreemptedEvent) for e in events), \
        "scenario must force a preemption inside the guarded region"
    assert SAMPLES.launches > draws, "the sampled request must draw inside the region"
    assert eng._decode_masked.replays > 0


def test_paged_freelist_engine_zero_builds_at_steady_state():
    cfg, eng = _engine(backend="paged", page_size=8, page_allocator="freelist",
                       pool_fraction=1.0, admit_watermark=0.25, paged_kernel=True)

    with compile_guard.count_captures() as warm:
        _drive_deferral_scenario(eng, _prompts(cfg, seed=0, n=3))
    assert warm.count > 0, "warm-up must build (guard sanity check)"
    deferrals_before = eng.pool_stats()["deferrals"]
    assert deferrals_before >= 1, "scenario must force a deferral"

    with compile_guard.assert_no_captures() as steady:
        _drive_deferral_scenario(eng, _prompts(cfg, seed=1, n=3))
    assert steady.count == 0
    # the deferral fired again inside the guarded region: page-table writes
    # and the late admission reused the step built at warm-up
    assert eng.pool_stats()["deferrals"] > deferrals_before
    assert eng.caches is eng._decode_masked.caches


def test_precision_map_engine_zero_builds_at_steady_state():
    """A map changes effective bits inside unchanged containers: the mapped
    engine builds what the unmapped one does, and a second pass nothing."""
    cfg, eng = _engine(precision_map="default=k8v8;layer:1-=k3v3")

    with compile_guard.count_captures() as warm:
        _drive_deferral_scenario(eng, _prompts(cfg, seed=0, n=3))
    assert warm.count > 0, "warm-up must build (guard sanity check)"

    with compile_guard.assert_no_captures() as steady:
        _drive_deferral_scenario(eng, _prompts(cfg, seed=1, n=3))
    assert steady.count == 0


def test_downshift_ladder_zero_builds_at_steady_state():
    """A downshift is an early fold through the rung-taking folds every armed
    fold uses (the rung an operand): pressure at steady state builds
    nothing.  The watermark over an exactly sized pool makes the trigger
    fire inside both regions."""
    cfg, eng = _engine(backend="paged", page_size=8, page_allocator="freelist",
                       pool_fraction=1.0, ladder_watermark=0.6, paged_kernel=True)

    with compile_guard.count_captures() as warm:
        _drive_deferral_scenario(eng, _prompts(cfg, seed=0, n=3))
    assert warm.count > 0, "warm-up must build (guard sanity check)"
    ds_before = eng.pool_stats()["downshift"]["downshifts"]
    assert ds_before >= 1, "scenario must force a downshift"

    with compile_guard.assert_no_captures() as steady:
        _drive_deferral_scenario(eng, _prompts(cfg, seed=1, n=3))
    assert steady.count == 0
    assert eng.pool_stats()["downshift"]["downshifts"] > ds_before
    assert eng.caches is eng._decode_masked.caches
    eng._alloc.check_invariants()


@pytest.mark.parametrize("extra_kw", [dict(pool_fraction=1.0),
                                      dict(pool_fraction=1.0, admit_watermark=0.25)],
                         ids=["plain", "watermarked"])
def test_swap_tier_zero_builds_at_steady_state(extra_kw):
    """Swap-out and swap-in at steady state reuse the step built at warm-up
    and the host entries made at construction: the mixed scenario's
    priority-2 short forces a swap-out, and its re-admission a swap-in,
    inside both regions, with no preemption by recompute."""
    cfg, eng = _engine(backend="paged", page_size=8, page_allocator="freelist",
                       scheduler="priority", preemption="swap", paged_kernel=True, **extra_kw)

    with compile_guard.count_captures() as warm:
        events = _drive_mixed_scenario(eng, _prompts(cfg, seed=0, n=4))
    assert warm.count > 0, "warm-up must build (guard sanity check)"
    dirs = [e.direction for e in events if isinstance(e, SwappedEvent)]
    assert "out" in dirs and "in" in dirs, dirs
    swaps_before = eng.pool_stats()["swap"]["swaps_in"]
    buffers = [entry.data_ptr() for entry in eng._swap._buffers]

    with compile_guard.assert_no_captures() as steady:
        events = _drive_mixed_scenario(eng, _prompts(cfg, seed=1, n=4))
    assert steady.count == 0
    dirs = [e.direction for e in events if isinstance(e, SwappedEvent)]
    assert "out" in dirs and "in" in dirs, dirs
    assert not any(isinstance(e, PreemptedEvent) for e in events)
    sw = eng.pool_stats()["swap"]
    assert sw["swaps_in"] > swaps_before
    assert sw["host_bytes"] == 0 and sw["resident"] == 0, sw
    assert [entry.data_ptr() for entry in eng._swap._buffers] == buffers
    assert eng.caches is eng._decode_masked.caches
    eng._alloc.check_invariants()


def test_prefix_cache_engine_zero_builds_at_steady_state():
    """Alias admissions, copy-on-write (page ids are data of the copy step),
    registrations and snapshot re-insertions at steady state build nothing:
    the second pass hits the first pass's index entry, copies and folds on
    the step built at warm-up."""
    cfg, eng = _engine(backend="paged", page_size=8, page_allocator="freelist",
                       pool_fraction=1.5, prefix_cache=True, paged_kernel=True)
    shared = np.arange(2, 26, dtype=np.int32)

    with compile_guard.count_captures() as warm:
        _drive_prefix_scenario(eng, shared, _prompts(cfg, seed=0, n=1)[0])
    assert warm.count > 0, "warm-up must build (guard sanity check)"
    pf = eng.pool_stats()["prefix"]
    assert pf["hits"] >= 1 and pf["cow_copies"] >= 1, pf

    with compile_guard.assert_no_captures() as steady:
        _drive_prefix_scenario(eng, shared, _prompts(cfg, seed=1, n=1)[0])
    assert steady.count == 0
    pf2 = eng.pool_stats()["prefix"]
    assert pf2["hits"] > pf["hits"] and pf2["cow_copies"] > pf["cow_copies"], (pf, pf2)
    assert eng.caches is eng._decode_masked.caches
    eng._alloc.check_invariants()


@pytest.mark.parametrize("policy", ["kivi", "h2o"])
@pytest.mark.parametrize("layout", ["mixed", "paged-freelist"])
def test_baseline_policy_zero_builds_at_steady_state(policy, layout):
    """kivi (the gather route: groupwise stores) and h2o (raw stores, the
    page walk on the paged layout).  On the mixed layout the first fold
    promotes the stores to f32 (the zero-capacity store's f32 parameters,
    as in the reference), so the warm-up builds the decode step twice; a
    second pass, with its admissions inserted into the promoted tree, its
    preemption and its folds, builds nothing.  The paged slot fold keeps
    the store dtype: one build."""
    if layout == "mixed":
        cfg, eng = _engine(policy, scheduler="priority", preemption="recompute")
        drive = _drive_mixed_scenario
        n = 4
    else:
        cfg, eng = _engine(policy, backend="paged", page_size=8, page_allocator="freelist",
                           pool_fraction=1.0, admit_watermark=0.25, paged_kernel=True)
        drive, n = _drive_deferral_scenario, 3

    with compile_guard.count_captures() as warm:
        drive(eng, _prompts(cfg, seed=0, n=n))
    assert warm.count == (2 if layout == "mixed" else 1), warm.describe()
    folds = eng._n_folds
    with compile_guard.assert_no_captures() as steady:
        drive(eng, _prompts(cfg, seed=1, n=n))
    assert steady.count == 0
    assert eng._n_folds > folds and eng._decode_masked.replays > 0
    assert eng.caches is eng._decode_masked.caches


def test_guard_counts_fresh_builds():
    """The guard itself: a step built inside the region is counted and
    named; `assert_no_captures` raises `RecaptureError` on it."""
    cfg, ccfg, params = _setup()
    shape = ShapeConfig("serve", 16, 2, "prefill")

    def fresh_step():
        step, ctx = steps_lib.make_continuous_decode_step(cfg, shape, ccfg, device="cpu")
        return step, registry.init_caches(cfg, ctx, 2, device="cpu")

    stage = steps_lib.stage_rows({0: (5, False)}, 2)
    step, caches = fresh_step()
    with compile_guard.count_captures() as log:
        step(params, caches, stage)
    assert log.count == 1 and log.names == ["continuous_decode"]
    with compile_guard.count_captures() as log2:
        step(params, caches, stage)              # built: nothing new
    assert log2.count == 0
    with pytest.raises(compile_guard.RecaptureError, match="continuous_decode"):
        with compile_guard.assert_no_captures():
            other, other_caches = fresh_step()
            other(params, other_caches, stage)   # a new step: a new build
