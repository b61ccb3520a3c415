"""Port parity for the host swap tier (`repro_torch.core.swap`, the engine's
`preemption="swap"`) and the downshift ladder under pressure, against the
JAX package on the same operations and the same parameters.

  * The swap protocol against the allocator (tests/test_page_alloc.py's
    round-trip sweep and refusal case): the port's allocator and host pool
    and the JAX package's, driven through the same admit / append / fold /
    swap-out / swap-in / free sequences side by side, give equal page
    tables, statistics and handles after every operation, the free-list
    partition holds, resident host bytes return to zero and every restore
    is bitwise the stored bytes; both refusals, aliased (a slot that shares
    prefix pages) and pool-full, are counted as the reference's.  The
    engine-level aliased refusals are in tests/test_torch_prefix_levers.py.
  * The two pressure scenarios of tests/test_backend_conformance.py, swap
    and ladder, on the port's engine and on the JAX engine (op by op,
    `jax.disable_jit()`, as in tests/test_torch_continuous.py) with the same
    parameters: tokens, finish reasons, every event and the `swap` /
    `downshift` blocks of `pool_stats()` equal.  On the port alone: swap
    tokens equal the recompute run's and the longs' the uncontended run's,
    an armed but unpressured ladder is bitwise the unarmed engine, and a
    cancelled swapped request returns its host entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import alloc as jalloc
from repro.core import swap as jswap
from repro.core.policy import CompressionConfig as JCompression
from repro.models import registry as jregistry
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.core import alloc, swap
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import (ContinuousEngine, DownshiftEvent, PreemptedEvent, Request,
                                 ServeConfig, SwappedEvent)
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


# ---------------------------------------------------------------------------
# the swap protocol against the allocator, side by side with the reference
# ---------------------------------------------------------------------------

def _pools(entries=2, mb=0):
    """A JAX and a port pool over the same two-tensor entry: 4 x 8 int8
    codes and 3 f32 metadata values."""
    template = {"codes": jax.ShapeDtypeStruct((4, 8), jnp.int8),
                "meta": [jax.ShapeDtypeStruct((3,), jnp.float32)]}
    return (jswap.HostSwapPool(template, swap_pool_mb=mb, fallback_entries=entries),
            swap.HostSwapPool([torch.zeros(4, 8, dtype=torch.int8), torch.zeros(3)],
                              swap_pool_mb=mb, fallback_entries=entries))


def _payload(seed: int):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-128, 127, size=(4, 8), dtype=np.int8)
    meta = rng.normal(size=(3,)).astype(np.float32)
    return ({"codes": jnp.asarray(codes), "meta": [jnp.asarray(meta)]},
            [torch.from_numpy(codes), torch.from_numpy(meta)])


def _assert_roundtrip(jloaded, tloaded, seed):
    (jp, tp) = _payload(seed)
    np.testing.assert_array_equal(np.asarray(jloaded["codes"]), np.asarray(jp["codes"]))
    np.testing.assert_array_equal(np.asarray(jloaded["meta"][0]), np.asarray(jp["meta"][0]))
    assert all(torch.equal(a, b) for a, b in zip(tloaded, tp))


def _assert_same(ja, ta, jpool, tpool):
    for name in alloc.FreeListAllocator.SEGMENTS:
        np.testing.assert_array_equal(ta.segs[name].table, ja.segs[name].table, err_msg=name)
        assert ta.segs[name].free == ja.segs[name].free, name
    js = ja.stats()
    assert ta.stats() == {k: js[k] for k in ta.stats()}
    assert tpool.stats() == jpool.stats()
    ja.check_invariants()
    ta.check_invariants()


def _ops(seed: int, n: int):
    rng = np.random.default_rng(seed)
    kinds = ("admit", "admit", "append", "append", "fold", "swap", "swap_in", "free")
    return [(kinds[int(rng.integers(len(kinds)))], int(rng.integers(64))) for _ in range(n)]


def _drive(pair, pools, ops, budgets):
    """tests/test_page_alloc.py's `_drive_swap`, on both sides at once: a
    swap-out takes the victim's occupancy before `free`, a swap-in re-admits
    with it.  Returns the completed round trips."""
    (ja, ta), (jpool, tpool) = pair, pools
    slots = ta.slots
    active = [None] * slots
    swapped = []                          # (handles, occ, budget, seed)
    roundtrips = 0
    for i, (op, arg) in enumerate(ops):
        slot = arg % slots
        if op == "admit" and active[slot] is None:
            t_max = budgets[arg % len(budgets)]
            assert ta.can_admit(t_max) == ja.can_admit(t_max)
            if ta.can_admit(t_max):
                prompt = max(t_max // 2, 1)
                hi = min(int(0.4 * prompt), ta.s_hi)
                lo = min(prompt - hi, ta.s_lo)
                ja.admit(slot, jalloc.Occupancy(hi=hi, lo=lo, win=0), t_max)
                ta.admit(slot, alloc.Occupancy(hi=hi, lo=lo, win=0), t_max)
                active[slot] = t_max
        elif op == "append" and active[slot] is not None:
            o = ta.occ[slot]
            if o.win < ta.window and o.hi + o.lo + o.win < active[slot]:
                ja.note_append(slot)
                ta.note_append(slot)
        elif op == "fold" and active[slot] is not None:
            for a in (ja, ta):
                a.fold_grant(slot)
            assert ja.fold_shrink(slot) == ta.fold_shrink(slot)
        elif op == "free" and active[slot] is not None:
            ja.free(slot)
            ta.free(slot)
            active[slot] = None
        elif op == "swap" and active[slot] is not None:
            handles = (jpool.reserve(), tpool.reserve())
            assert handles[0] == handles[1]
            if handles[1] is not None:
                occ = ta.occ[slot]
                jp, tp = _payload(i)
                jpool.store(handles[0], jp)
                tpool.store(handles[1], tp)
                swapped.append((handles, occ, active[slot], i))
            ja.free(slot)                   # pool full: the engine preempts instead
            ta.free(slot)
            active[slot] = None
        elif op == "swap_in" and swapped and active[slot] is None:
            entry = swapped[arg % len(swapped)]
            handles, occ, t_max, seed = entry
            if ta.can_admit(t_max):
                swapped.remove(entry)
                ja.admit(slot, jalloc.Occupancy(occ.hi, occ.lo, occ.win), t_max)
                ta.admit(slot, occ, t_max)
                _assert_roundtrip(jpool.load(handles[0]), tpool.load(handles[1], "cpu"), seed)
                jpool.release(handles[0])
                tpool.release(handles[1])
                active[slot] = t_max
                roundtrips += 1
        _assert_same(ja, ta, jpool, tpool)
        st = tpool.stats()
        assert st["resident"] == len(swapped)
        assert st["host_bytes"] == len(swapped) * st["entry_bytes"]
    # drain: restore or cancel every entry, then free everything
    for handles, occ, t_max, seed in swapped:
        free_slots = [s for s in range(slots) if active[s] is None]
        if free_slots and ta.can_admit(t_max):
            slot = free_slots[0]
            ja.admit(slot, jalloc.Occupancy(occ.hi, occ.lo, occ.win), t_max)
            ta.admit(slot, occ, t_max)
            _assert_roundtrip(jpool.load(handles[0]), tpool.load(handles[1], "cpu"), seed)
            active[slot] = t_max
            roundtrips += 1
        jpool.release(handles[0])
        tpool.release(handles[1])
        _assert_same(ja, ta, jpool, tpool)
    for s in range(slots):
        if active[s] is not None:
            ja.free(s)
            ta.free(s)
    _assert_same(ja, ta, jpool, tpool)
    for name, seg in ta.segs.items():
        assert len(seg.free) == seg.pool_pages, name
    assert tpool.stats()["host_bytes"] == 0
    return roundtrips


def _allocators(slots, page, fraction):
    caps = (24, 40, 8)
    pools = tuple(max(int(np.ceil(slots * alloc.pages_for(c, page) * fraction)),
                      alloc.pages_for(c, page)) for c in caps)
    return (jalloc.FreeListAllocator(slots, page, caps, pools),
            alloc.FreeListAllocator(slots, page, caps, pools))


@pytest.mark.parametrize("seed", range(20))
def test_swap_roundtrip_sweep_matches_reference(seed):
    """The deterministic sweep of the swap property test: each seed's slots,
    page size and pool fraction as the reference's, both sides in step."""
    slots, page, fraction = 1 + seed % 4, (4, 8)[seed % 2], (0.6, 1.0, 1.4)[seed % 3]
    _drive(_allocators(slots, page, fraction), _pools(entries=max(slots, 2)),
           _ops(seed, 150), [16, 40, 64, 72])


def test_swap_sweep_completes_roundtrips():
    """The sweep is not vacuous: its seeds complete swap round trips, and so
    does a short pool (fewer entries than slots, the pool-full path)."""
    total = sum(_drive(_allocators(1 + s % 4, (4, 8)[s % 2], (0.6, 1.0, 1.4)[s % 3]),
                       _pools(entries=max(1 + s % 4 - 1, 1)), _ops(s, 120), [16, 40, 64, 72])
                for s in range(6))
    assert total > 0


def test_swap_pool_full_refusal_and_recycling():
    """The pool-full half of tests/test_page_alloc.py's refusal case, with no
    prefix registered: a capacity-1 pool with its entry resident refuses
    with a counted pool_full; a restore closes both ledgers; the released
    handle recycles into the same preallocated buffers.  No slot shares a
    page, so `needs_privatize` is False for every one."""
    ja, ta = _allocators(3, 8, 1.5)
    jpool, tpool = _pools(entries=1)
    assert tpool.capacity == 1 and tpool.entry_bytes == 4 * 8 + 3 * 4
    assert _pools(mb=1)[1].capacity == (1 << 20) // tpool.entry_bytes == _pools(mb=1)[0].capacity
    occ0 = alloc.Occupancy(hi=8, lo=12, win=0)
    for s in range(3):
        ja.admit(s, jalloc.Occupancy(8, 12, 0), 40)
        ta.admit(s, occ0, 40)
        assert not ta.needs_privatize(s)
    occ = ta.occ[2]
    h = tpool.reserve()
    assert h is not None and h == jpool.reserve()
    jp, tp = _payload(7)
    jpool.store(h, jp)
    tpool.store(h, tp)
    ja.free(2)
    ta.free(2)
    assert tpool.reserve() is None and jpool.reserve() is None
    st = tpool.stats()
    assert st["refusals"] == {"aliased": 0, "pool_full": 1} and st["swap_refusals"] == 1
    assert st["host_bytes"] == st["entry_bytes"] > 0
    _assert_same(ja, ta, jpool, tpool)
    ja.admit(2, jalloc.Occupancy(occ.hi, occ.lo, occ.win), 40)
    ta.admit(2, occ, 40)
    _assert_roundtrip(jpool.load(h), tpool.load(h, "cpu"), 7)
    jpool.release(h)
    tpool.release(h)
    st = tpool.stats()
    assert st["host_bytes"] == 0 and st["resident"] == 0
    assert st["swaps_out"] == 1 and st["swaps_in"] == 1
    _assert_same(ja, ta, jpool, tpool)
    assert tpool.reserve() == h == jpool.reserve()


def test_swap_refuses_aliased_and_full_pool_counts():
    """tests/test_page_alloc.py's refusal case, both allocators and pools in
    step, over a pool that holds a registered prefix: the donor and its
    alias (pages at refcount > 1) are refused before an entry is reserved
    (counted "aliased"); the unaliased slot swaps out; a second reservation
    of the capacity-1 pool refuses with a counted pool_full; the restore
    closes both ledgers."""
    ja, ta = _allocators(3, 8, 1.5)
    jpool, tpool = _pools(entries=1)
    occ = alloc.Occupancy(hi=3, lo=5, win=0)
    for a, o in ((ja, jalloc.Occupancy(3, 5, 0)), (ta, occ)):
        a.admit(0, o, 40, 8)                                  # donor
        assert a.prefix_register("sys", 0)
        a.admit_alias(1, "sys", 40, 8, can_fold=True)
        a.admit(2, o, 40, 8)                                  # the only victim
    _assert_same(ja, ta, jpool, tpool)
    for victim in (0, 1):
        assert ta.needs_privatize(victim) and ja.needs_privatize(victim)
        jpool.note_refusal("aliased")
        tpool.note_refusal("aliased")
    assert not ta.needs_privatize(2)
    saved = ta.occ[2]
    h = tpool.reserve()
    assert h is not None and h == jpool.reserve()
    jp, tp = _payload(7)
    jpool.store(h, jp)
    tpool.store(h, tp)
    ja.free(2)
    ta.free(2)
    _assert_same(ja, ta, jpool, tpool)
    assert tpool.reserve() is None and jpool.reserve() is None
    st = tpool.stats()
    assert st["refusals"] == {"aliased": 2, "pool_full": 1} and st["swap_refusals"] == 3
    assert st == jpool.stats()
    ja.admit(2, jalloc.Occupancy(saved.hi, saved.lo, saved.win), 40, 8)
    ta.admit(2, saved, 40, 8)
    _assert_roundtrip(jpool.load(h), tpool.load(h, "cpu"), 7)
    jpool.release(h)
    tpool.release(h)
    _assert_same(ja, ta, jpool, tpool)
    assert tpool.stats()["host_bytes"] == 0 and tpool.reserve() == h == jpool.reserve()


def test_swap_store_rejects_a_payload_of_another_shape():
    _, tpool = _pools()
    h = tpool.reserve()
    with pytest.raises(ValueError):
        tpool.store(h, [torch.zeros(4, 8, dtype=torch.int8)])
    with pytest.raises(ValueError):
        tpool.store(h, [torch.zeros(4, 8), torch.zeros(3)])


# ---------------------------------------------------------------------------
# the pressure scenarios, port against the JAX engine
# ---------------------------------------------------------------------------

def _ccfgs():
    return (dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8),
            dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8))


def _swap_run(make, request, prompts, preemption, contended=True, swap_pool_mb=0):
    """Two priority-0 longs, then (contended) a priority-2 short that forces
    a victim once both slots are held."""
    eng = make(dict(batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8,
                    backend="paged", page_allocator="freelist", pool_fraction=1.0,
                    scheduler="priority", preemption=preemption, swap_pool_mb=swap_pool_mb))
    rids = [eng.submit(request(tokens=prompts[0])), eng.submit(request(tokens=prompts[1]))]
    events = []
    for _ in range(4):
        events += eng.step()
    if contended:
        rids.append(eng.submit(request(tokens=prompts[2], max_new_tokens=3, priority=2)))
    while eng.pending:
        events += eng.step()
        eng._alloc.check_invariants()
    outs = [(eng.result(r).tokens.tolist(), eng.result(r).finish_reason) for r in rids]
    return outs, eng.pool_stats(), [dataclasses.asdict(e) | {"kind": type(e).__name__}
                                    for e in events]


def _ladder_run(make, request, prompts, pool_fraction, ladder_watermark=0.0):
    """tests/test_backend_conformance.py's ladder scenario: a short request
    retiring after 6 tokens, a third submitted mid-run."""
    eng = make(dict(batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8,
                    backend="paged", page_allocator="freelist", pool_fraction=pool_fraction,
                    ladder_watermark=ladder_watermark))
    rids = [eng.submit(request(tokens=prompts[0])),
            eng.submit(request(tokens=prompts[1], max_new_tokens=6))]
    events = []
    for _ in range(4):
        events += eng.step()
    rids.append(eng.submit(request(tokens=prompts[2])))
    while eng.pending:
        events += eng.step()
        eng._alloc.check_invariants()
    outs = [(eng.result(r).tokens.tolist(), eng.result(r).finish_reason) for r in rids]
    return outs, eng.pool_stats(), [dataclasses.asdict(e) | {"kind": type(e).__name__}
                                    for e in events]


@pytest.fixture(scope="module")
def runs():
    """The JAX engine's swap and pressured ladder runs, and the port's
    engine factory over the same parameters."""
    jcfg = jconfigs.get_arch("yi-6b", smoke=True)
    jccfg, ccfg = _ccfgs()
    jparams = jregistry.materialize_params(jcfg, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab, size=(48,)).astype(np.int32) for _ in range(3)]

    def jmake(kw):
        return JContinuousEngine(jcfg, jccfg, JServeConfig(**kw), jparams)

    with jax.disable_jit():
        reference = {"swap": _swap_run(jmake, JRequest, prompts, "swap", swap_pool_mb=1),
                     "ladder": _ladder_run(jmake, JRequest, prompts, 1.0, 0.6)}
    cfg = configs.get_arch("yi-6b", smoke=True)
    params = convert.from_jax_params(jax.device_get(jparams), cfg, device="cpu")

    def make(kw):
        return ContinuousEngine(cfg, ccfg, ServeConfig(**kw), params, device="cpu")

    return {"reference": reference, "make": make, "prompts": prompts, "params": params}


def _kinds(events):
    return [e["kind"] for e in events if e["kind"] != "TokenEvent"]


def test_swap_pressure_matches_reference(runs):
    """The swap scenario: a swap-out and a swap-in fire (no preemption by
    recompute), and tokens, finish reasons, every event (the swaps' host
    bytes included) and the swap block equal the JAX engine's."""
    outs, stats, events = _swap_run(runs["make"], Request, runs["prompts"], "swap",
                                    swap_pool_mb=1)
    r_outs, r_stats, r_events = runs["reference"]["swap"]
    assert outs == r_outs
    assert events == r_events
    assert stats["swap"] == r_stats["swap"]
    assert {k: stats[k] for k in ("hi", "lo", "win", "deferrals", "preemptions", "downshift")} \
        == {k: r_stats[k] for k in ("hi", "lo", "win", "deferrals", "preemptions", "downshift")}
    kinds = _kinds(events)
    assert kinds.count("SwappedEvent") >= 2 and "PreemptedEvent" not in kinds
    sw = stats["swap"]
    assert sw["swaps_out"] >= 1 and sw["swaps_in"] == sw["swaps_out"]
    assert sw["host_bytes"] == 0 and sw["resident"] == 0 and sw["entry_bytes"] > 0


def test_swap_tokens_equal_recompute_and_uncontended(runs):
    """On the port alone: the swap run's tokens equal the recompute run's,
    and the longs' equal the uncontended run's; the tier exists only when
    armed, and every page comes home."""
    make, prompts = runs["make"], runs["prompts"]
    out_ref, _, _ = _swap_run(make, Request, prompts, "recompute", contended=False)
    out_rc, st_rc, ev_rc = _swap_run(make, Request, prompts, "recompute")
    out_sw, st_sw, _ = _swap_run(make, Request, prompts, "swap", swap_pool_mb=1)
    assert "PreemptedEvent" in _kinds(ev_rc)
    assert out_sw == out_rc and out_sw[:2] == out_ref
    assert "swap" not in st_rc
    for st in (st_rc, st_sw):
        assert all(st[seg]["used"] == 0 for seg in ("hi", "lo", "win"))


def test_ladder_pressure_matches_reference(runs):
    """The pressured ladder: downshifts fire and free window pages, and
    tokens (degraded by design), events and the downshift block equal the
    JAX engine's."""
    outs, stats, events = _ladder_run(runs["make"], Request, runs["prompts"], 1.0, 0.6)
    r_outs, r_stats, r_events = runs["reference"]["ladder"]
    assert outs == r_outs
    assert events == r_events
    assert stats["downshift"] == r_stats["downshift"]
    ds = stats["downshift"]
    assert ds["downshifts"] >= 1 and ds["pages_freed"] >= 1 and ds["refusals"] == 0
    assert "DownshiftEvent" in _kinds(events)
    assert all(reason == "length" for _, reason in outs)
    assert all(stats[seg]["used"] == 0 for seg in ("hi", "lo", "win"))


def test_armed_unpressured_ladder_is_bitwise_default(runs):
    """Arming the ladder over a pool that never runs low fires nothing, and
    its folds at rung 0 are bitwise the unarmed engine's."""
    make, prompts = runs["make"], runs["prompts"]
    out_base, st_base, _ = _ladder_run(make, Request, prompts, 1.0)
    out_armed, st_armed, ev = _ladder_run(make, Request, prompts, 1.5, 0.01)
    assert out_armed == out_base
    assert st_base["downshift"]["downshifts"] == 0
    assert st_armed["downshift"] == {"downshifts": 0, "pages_freed": 0, "refusals": 0}
    assert "DownshiftEvent" not in _kinds(ev)
    eng = make(dict(batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8,
                    backend="paged", page_allocator="freelist", scheduler="priority",
                    preemption="downshift"))
    assert eng._recompress_rows_rung is not None and eng._recompress_slot_rung is not None


def test_cancelled_swapped_request_returns_its_entry(runs):
    """A request cancelled while swapped out releases its host entry (host
    bytes back to 0) and keeps the tokens it had decoded."""
    make, prompts = runs["make"], runs["prompts"]
    eng = make(dict(batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8,
                    backend="paged", page_allocator="freelist", scheduler="priority",
                    preemption="swap"))
    low = [eng.submit(Request(tokens=p)) for p in prompts[:2]]
    for _ in range(4):
        eng.step()
    eng.submit(Request(tokens=prompts[2], max_new_tokens=3, priority=2))
    events = eng.step()
    out = [e for e in events if isinstance(e, SwappedEvent) and e.direction == "out"]
    assert len(out) == 1 and eng.pool_stats()["swap"]["host_bytes"] > 0
    victim = out[0].request_id
    assert victim in low and eng.poll(victim) == "queued"
    assert eng.cancel(victim)
    assert eng.pool_stats()["swap"]["host_bytes"] == 0
    eng.run()
    assert eng.result(victim).finish_reason == "cancelled"
    assert len(eng.result(victim).tokens) == out[0].n_generated
    assert not any(isinstance(e, (PreemptedEvent, DownshiftEvent)) for e in events)


@pytest.mark.parametrize("lever", [dict(preemption="swap"), dict(ladder_watermark=0.5),
                                   dict(preemption="downshift")],
                         ids=["swap", "ladder", "downshift"])
@pytest.mark.parametrize("backend", [dict(backend="mixed"), dict(backend="paged")],
                         ids=["mixed", "paged-static"])
def test_levers_need_the_free_list(runs, lever, backend):
    with pytest.raises(ValueError, match="freelist"):
        runs["make"](dict(batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8,
                          scheduler="priority", **backend, **lever))


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


@pytest.mark.parametrize("scenario", ["swap", "ladder"])
def test_static_buffer_steps_equal_eager_through_levers(runs, scenario):
    """The decode step over its static cache tree (what a replay reads on
    the card) against `capture=False`, step by step through a swap-out and
    restore or through downshifts: a restore or an early fold that left a
    static leaf stale would show in the steps after it."""
    cfg = configs.get_arch("yi-6b", smoke=True)
    _, ccfg = _ccfgs()
    got = []
    for capture in (False, True):
        recs = []

        def make(kw, capture=capture):
            kw = dict(kw, paged_kernel=True, precision_map="default=k8v8;layer:1-=k3v3")
            eng = ContinuousEngine(cfg, ccfg, ServeConfig(**kw), runs["params"], device="cpu",
                                   capture=capture)
            eng._decode_masked = _Logits(eng._decode_masked)
            recs.append(eng._decode_masked)
            return eng

        if scenario == "swap":
            outs, _, events = _swap_run(make, Request, runs["prompts"], "swap")
        else:
            outs, _, events = _ladder_run(make, Request, runs["prompts"], 1.0, 0.6)
        got.append((outs, _kinds(events), recs[0]))
    (o_eager, k_eager, eager), (o_static, k_static, static) = got
    assert o_static == o_eager and k_static == k_eager
    assert ("SwappedEvent" if scenario == "swap" else "DownshiftEvent") in k_static
    assert static.step.captures == 1 and static.step.replays > 0
    assert len(static.logits) == len(eager.logits)
    assert all(torch.equal(a, w) for a, w in zip(static.logits, eager.logits))
