"""Port parity for shared-prefix page dedup with copy-on-write tables
(`repro_torch.core.alloc`'s prefix index, `paged.copy_pages`, the continuous
engine's `prefix_cache`), against the JAX package.

  * `prefix_key`: the same sha256 chain digests as the reference's.
  * The allocators, op for op: the port's and the JAX package's driven
    through the same admit / alias / register / append / privatize / fold /
    free / reclaim sequences (tests/test_page_alloc.py's `_drive_prefix`, with
    appends capped at each slot's admitted total, the engine's contract):
    tables, refcounts, ownership, free lists, the moves `privatize` returns
    and `stats()` (prefix block included) equal after every op.  The
    reference's unit cases of the index (alias / privatize round trip,
    adoption without a copy, the stale-page guard, a refused registration,
    a downshift storm) run the same way.
  * The Hypothesis property of the prefix invariants, with the example the
    reference's test records (`seed=2, slots=2, page=4, fraction=1.0`) as a
    fixed case; and the guard the port adds: an append past the admitted
    total trips a named assertion in `note_append`.
  * The engine at the reference's shared-prompt scenario
    (tests/test_backend_conformance.py: four requests on one 24-token
    prompt, the last one too short to fold): tokens with dedup on equal
    those with it off and the JAX engine's; hits, CoW copies and skipped
    prefill tokens as the reference's; the snapshot a hit re-inserts is
    still bitwise a fresh prefill after the run.

The JAX engine runs op by op (`jax.disable_jit()`), as in
tests/test_torch_continuous.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import example, given, settings, strategies as st
except ImportError:
    from tests._hypothesis_stub import given, settings, st

    def example(**_kw):
        return lambda fn: fn

from repro import configs as jconfigs
from repro.core import alloc as jalloc
from repro.core.policy import CompressionConfig as JCompression
from repro.models import registry as jregistry
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.core import alloc
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import ContinuousEngine, Request, ServeConfig
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

PROMPT = 8                                      # tests/test_page_alloc.py's
OCC = (3, 5, 0)                                 # ratio split of 8 tokens
BUDGETS = (16, 40, 64)


# ---------------------------------------------------------------------------
# prefix_key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_prefix_key_matches_reference(seed):
    rng = np.random.default_rng(seed)
    page = int(rng.choice([4, 8, 16, 64]))
    bucket = page * int(rng.integers(1, 5))
    for n in (0, 1, bucket // 2, bucket):
        toks = rng.integers(0, 64000, size=(n,)).astype(np.int32)
        assert alloc.prefix_key(toks, page, bucket) == jalloc.prefix_key(toks, page, bucket)
    toks = rng.integers(0, 64000, size=(bucket,)).astype(np.int32)
    other = toks.copy()
    other[-1] ^= 1
    assert alloc.prefix_key(toks, page, bucket) != alloc.prefix_key(other, page, bucket)
    with pytest.raises(ValueError):
        alloc.prefix_key(toks, page, bucket - 1)


# ---------------------------------------------------------------------------
# the two allocators side by side
# ---------------------------------------------------------------------------

def _norm(x):
    """A return value comparable across the two packages."""
    if isinstance(x, (alloc.PrefixEntry, jalloc.PrefixEntry)):
        return (x.key, x.pages, _norm(x.occ), x.hits)
    if isinstance(x, (alloc.Occupancy, jalloc.Occupancy)):
        return (x.hi, x.lo, x.win)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    return x


def _assert_same(j, t):
    for name in alloc.FreeListAllocator.SEGMENTS:
        sj, stt = j.segs[name], t.segs[name]
        for field in ("table", "granted", "worst", "refcount", "owned"):
            np.testing.assert_array_equal(getattr(stt, field), getattr(sj, field),
                                          err_msg=f"{name}.{field}")
        assert stt.free == sj.free, name
    assert t.stats() == j.stats()
    assert [_norm(o) for o in t.occ] == [_norm(o) for o in j.occ]
    assert [_norm(e) for e in t.prefix.values()] == [_norm(e) for e in j.prefix.values()]
    assert t.admit_headroom() == j.admit_headroom()
    assert t.dirty == j.dirty
    j.check_invariants()
    t.check_invariants()


class _Pair:
    """A JAX and a port allocator over the same pools.  `call(name, ...)`
    runs one method on both, asserts equal results and equal states, and
    returns the port's result."""

    def __init__(self, slots, page, fraction, caps=(24, 40, 8)):
        pools = tuple(max(int(np.ceil(slots * alloc.pages_for(c, page) * fraction)),
                          alloc.pages_for(c, page)) for c in caps)
        self.j = jalloc.FreeListAllocator(slots, page, caps, pools)
        self.t = alloc.FreeListAllocator(slots, page, caps, pools)

    def call(self, name, *args, **kw):
        jargs = [jalloc.Occupancy(*_norm(a)) if isinstance(a, alloc.Occupancy) else a
                 for a in args]
        rj = getattr(self.j, name)(*jargs, **kw)
        rt = getattr(self.t, name)(*args, **kw)
        assert _norm(rt) == _norm(rj), name
        _assert_same(self.j, self.t)
        return rt


def _ops(seed: int, n: int):
    rng = np.random.default_rng(seed)
    kinds = ("admit", "admit", "append", "append", "fold", "free", "reclaim")
    return [(kinds[int(rng.integers(len(kinds)))], int(rng.integers(64))) for _ in range(n)]


def _drive(a, ops, check=None, cap_appends=True):
    """tests/test_page_alloc.py's `_drive_prefix` on allocator-like `a` (an
    allocator, or a `_Pair` through `check`): aliases only on indexed keys
    with headroom, privatize before every fold, never fold a can_fold=False
    alias.  Appends stop at the slot's admitted total (the engine retires a
    request at its budget) unless `cap_appends` is False.  Returns op
    counters."""
    call = check or (lambda name, *args, **kw: getattr(a, name)(*args, **kw))
    slots = a.slots
    fold_ok = [True] * slots
    total = [0] * slots
    counts = {"admit": 0, "alias": 0, "register": 0, "fold": 0, "cow": 0, "reclaim": 0}
    for op, arg in ops:
        slot = arg % slots
        if op == "admit":
            if a.occ[slot] is not None:
                continue
            key, t_max = f"k{arg % 3}", BUDGETS[arg % 3]
            if a.prefix_peek(key) is not None:
                can_fold = arg % 2 == 0
                worst = a.worst_pages(t_max, PROMPT)
                if not can_fold:
                    worst = {**worst, "hi": 0, "lo": 0}
                if all(a.segs[n].headroom(0) >= worst[n] for n in a.SEGMENTS):
                    call("admit_alias", slot, key, t_max, PROMPT, can_fold=can_fold)
                    fold_ok[slot], total[slot] = can_fold, t_max
                    counts["alias"] += 1
            elif a.can_admit(t_max, PROMPT):
                call("admit", slot, alloc.Occupancy(*OCC), t_max, PROMPT)
                fold_ok[slot], total[slot] = True, t_max
                counts["admit"] += 1
                if arg % 4 != 3:   # the engine registers at the end of the pass
                    counts["register"] += call("prefix_register", key, slot)
        elif a.occ[slot] is None:
            continue
        elif op == "append":
            o = a.occ[slot]
            if o.win < a.window and (not cap_appends or o.hi + o.lo + o.win < total[slot]):
                call("note_append", slot)
        elif op == "fold":
            if not fold_ok[slot]:
                continue            # a never-fold alias reserved no hi/lo pages
            if a.needs_privatize(slot):
                moves = call("privatize", slot)
                counts["cow"] += sum(len(s) for s, _ in moves.values())
            call("fold_grant", slot)
            call("fold_shrink", slot)
            counts["fold"] += 1
        elif op == "free":
            call("free", slot)
        elif op == "reclaim":
            counts["reclaim"] += len(call("prefix_reclaim"))
        a.check_invariants()
    return counts


def _drain(call, a):
    """Free every slot and evict the whole index: every page comes back."""
    for s in range(a.slots):
        if a.occ[s] is not None:
            call("free", s)
    call("prefix_reclaim", min_pages=10**9)
    a.check_invariants()
    for name, seg in a.segs.items():
        assert len(seg.free) == seg.pool_pages, name
        assert not seg.refcount.any(), name


def _sweep_case(seed):
    """tests/test_page_alloc.py's deterministic sweep: slots, page and pool
    fraction by seed."""
    return 2 + seed % 3, (4, 8)[seed % 2], (0.7, 1.0, 1.5)[seed % 3]


@pytest.mark.parametrize("seed", range(30))
def test_allocators_match_op_for_op(seed):
    pair = _Pair(*_sweep_case(seed))
    _drive(pair.t, _ops(seed, 150), check=pair.call)
    _drain(pair.call, pair.t)


def test_sweep_exercises_alias_register_and_cow():
    """The sweep is not vacuous: registrations, aliases and CoW copies all
    fire somewhere in it."""
    totals = {"alias": 0, "register": 0, "cow": 0, "reclaim": 0}
    for seed in range(30):
        slots, page, fraction = _sweep_case(seed)
        pair = _Pair(slots, page, fraction)
        counts = _drive(pair.t, _ops(seed, 150), check=pair.call)
        for k in totals:
            totals[k] += counts[k]
    assert all(v > 0 for v in totals.values()), totals


@given(seed=st.integers(min_value=0, max_value=10_000),
       slots=st.integers(min_value=1, max_value=4),
       page=st.sampled_from([4, 8]),
       fraction=st.floats(min_value=0.5, max_value=1.6))
@example(seed=2, slots=2, page=4, fraction=1.0)
@settings(max_examples=50, deadline=None, database=None)
def test_prefix_invariants_random_sequences(seed, slots, page, fraction):
    """The refcount partition, reservation coverage through ownership
    rescission, and no `PagePoolExhausted`, under random interleavings of
    registration, aliasing, CoW, folds, eviction and slot churn, with
    appends within each slot's admitted total; both allocators in step.
    The example is the one tests/test_page_alloc.py's run records: under
    the engine's contract it holds."""
    pair = _Pair(slots, page, fraction)
    _drive(pair.t, _ops(seed, 120), check=pair.call)
    _drain(pair.call, pair.t)


def test_append_past_the_admitted_total_trips_note_append():
    """The guard the port adds: a slot caching more tokens than it was
    admitted with (prompt bucket + budget) would draw pages beyond its
    reservation, and `note_append` refuses by name.  The recorded example
    of the reference's property test, driven without the cap, trips it
    where the reference's coverage check later breaks."""
    a = _Pair(2, 4, 1.0).t
    a.admit(0, alloc.Occupancy(*OCC), 10, PROMPT)
    a.note_append(0)
    a.note_append(0)                             # 10 tokens: the total
    with pytest.raises(AssertionError, match=r"note_append: slot 0 .*admitted total 10"):
        a.note_append(0)
    with pytest.raises(AssertionError, match="note_append: slot .*admitted total"):
        _drive(_Pair(2, 4, 1.0).t, _ops(2, 120), cap_appends=False)


def _admit_donor(pair, slot, total=40):
    pair.call("admit", slot, alloc.Occupancy(*OCC), total, PROMPT)


def test_alias_write_privatize_roundtrip():
    """tests/test_page_alloc.py's CoW story on both allocators: register a
    donor, alias a second slot, `fold_grant` refuses the aliased slot,
    privatize (copies, refcounts down) and fold both, retire both; the
    index keeps its pages until eviction."""
    pair = _Pair(2, 8, 1.5)
    t = pair.t
    _admit_donor(pair, 0)
    assert pair.call("prefix_register", "sys", 0)
    assert t.needs_privatize(0)
    hi = t.segs["hi"]
    donor_pages = [int(p) for p in hi.table[0, :hi.granted[0]]]
    assert all(hi.refcount[p] == 2 for p in donor_pages)
    pair.call("admit_alias", 1, "sys", 40, PROMPT, can_fold=True)
    assert all(hi.refcount[p] == 3 for p in donor_pages)
    assert t.stats()["prefix"]["shared_pages"] >= 1
    for a in (pair.j, t):
        with pytest.raises(AssertionError, match="privatize"):
            a.fold_grant(1)
    moves = pair.call("privatize", 1)
    assert moves and all(s != d for n in moves for s, d in zip(*moves[n]))
    assert not t.needs_privatize(1)
    pair.call("fold_grant", 1)
    pair.call("fold_shrink", 1)
    pair.call("privatize", 0)         # the donor's ownership went at registration
    pair.call("fold_grant", 0)
    pair.call("fold_shrink", 0)
    assert all(hi.refcount[p] == 1 for p in donor_pages)   # the index only
    pair.call("free", 0)
    pair.call("free", 1)
    assert pair.call("prefix_reclaim", min_pages=10**9) == ["sys"]
    _drain(pair.call, t)


def test_sole_referent_alias_is_adopted_without_copy():
    pair = _Pair(2, 8, 1.5)
    _admit_donor(pair, 0, total=16)
    assert pair.call("prefix_register", "sys", 0)
    pair.call("free", 0)
    pair.call("admit_alias", 1, "sys", 40, PROMPT, can_fold=True)
    assert pair.call("prefix_reclaim", min_pages=10**9) == ["sys"]
    assert pair.t.needs_privatize(1)
    assert pair.call("privatize", 1) == {}
    assert not pair.t.needs_privatize(1) and pair.t.cow_copies == 0
    pair.call("fold_grant", 1)
    pair.call("fold_shrink", 1)


def test_regrant_of_still_referenced_page_asserts():
    """The stale-page guard in `grant`: a page on the free list that a table
    still references trips an assertion naming its refcount."""
    t = _Pair(2, 8, 1.0).t
    t.admit(0, alloc.Occupancy(*OCC), 16, PROMPT)
    hi = t.segs["hi"]
    hi.free.append(int(hi.table[0, 0]))
    with pytest.raises(AssertionError, match="refcount"):
        hi.grant(1, 1)


def test_register_refused_without_slack_is_not_corrupting():
    pair = _Pair(2, 8, 1.0)
    for s in range(2):
        _admit_donor(pair, s, total=64)
    hi = pair.t.segs["hi"]
    before = (hi.table.copy(), hi.refcount.copy(), hi.owned.copy())
    assert not pair.call("prefix_register", "sys", 0)
    assert not pair.t.prefix and not pair.t.needs_privatize(0)
    for a, b in zip(before, (hi.table, hi.refcount, hi.owned)):
        np.testing.assert_array_equal(a, b)
    assert not pair.call("prefix_register", "sys", 0)


def test_downshift_storm_preserves_refcount_partition():
    """tests/test_page_alloc.py's storm on both allocators: the donor and
    its alias are refused every round (`note_downshift_refusal`), the
    unaliased slot downshifts and frees its window pages."""
    page = 8
    pair = _Pair(3, page, 1.5)
    t = pair.t
    _admit_donor(pair, 0)
    assert pair.call("prefix_register", "sys", 0)
    pair.call("admit_alias", 1, "sys", 40, PROMPT, can_fold=True)
    _admit_donor(pair, 2)
    refusals = downshifts = freed_total = 0
    for cycle in range(12):
        for slot in range(3):
            o = t.occ[slot]
            if o.win < t.window and o.hi + o.lo + o.win < 40:
                pair.call("note_append", slot)
        victim = cycle % 3
        if t.needs_privatize(victim):
            pair.call("note_downshift_refusal")
            refusals += 1
            assert victim in (0, 1)
        elif t.occ[victim].win > 0:
            win = t.occ[victim].win
            pair.call("fold_grant", victim)
            freed = pair.call("fold_shrink", victim)
            assert freed == alloc.pages_for(win, page)
            pair.call("note_downshift", victim, freed)
            downshifts += 1
            freed_total += freed
    assert t.stats()["downshift"] == {"downshifts": downshifts, "pages_freed": freed_total,
                                      "refusals": refusals}
    assert downshifts >= 1 and refusals >= 1 and freed_total >= 1
    _drain(pair.call, t)
    assert t.pool_pressure() == 1.0


# ---------------------------------------------------------------------------
# the engine at the reference's shared-prompt scenario
# ---------------------------------------------------------------------------

SHARED = np.arange(2, 26, dtype=np.int32)       # 24 tokens: a 3-page bucket


def _shared_run(make, request, prefix_on):
    """tests/test_backend_conformance.py's shared-prompt scenario: three full
    requests and one of budget 4 (never folds) on one prompt; the
    allocator's invariants after every step.  -> (outputs, pool stats,
    engine)."""
    eng = make(dict(batch_size=2, prompt_len=32, max_new_tokens=12, page_size=8,
                    backend="paged", page_allocator="freelist", pool_fraction=1.5,
                    prefix_cache=prefix_on))
    reqs = [request(tokens=SHARED.copy(), id=f"r{i}") for i in range(3)]
    reqs.append(request(tokens=SHARED.copy(), id="r3", max_new_tokens=4))
    for r in reqs:
        eng.submit(r)
    while eng.pending:
        eng.step()
        eng._alloc.check_invariants()
    outs = [(eng.result(r.id).tokens.tolist(), eng.result(r.id).finish_reason) for r in reqs]
    return outs, eng.pool_stats(), eng


@pytest.fixture(scope="module")
def shared():
    jcfg = jconfigs.get_arch("yi-6b", smoke=True)
    jccfg = dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8)
    jparams = jregistry.materialize_params(jcfg, seed=0)
    with jax.disable_jit():
        reference = _shared_run(
            lambda kw: JContinuousEngine(jcfg, jccfg, JServeConfig(**kw), jparams), JRequest,
            True)[:2]
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(jax.device_get(jparams), cfg, device="cpu")

    def make(kw, capture=True):
        return ContinuousEngine(cfg, ccfg, ServeConfig(**kw), params, device="cpu",
                                capture=capture)

    return {"reference": reference, "make": make}


@pytest.mark.parametrize("capture", [True, False], ids=["static", "eager"])
def test_shared_prompt_dedup_matches_reference(shared, capture):
    """Dedup on: tokens equal dedup off and the JAX engine's; at least one
    hit and one CoW copy; every hit skipped its 24-token bucket; the prefix
    block (hits, misses, CoW copies, shared pages, skipped tokens) equal to
    the JAX engine's."""
    make = lambda kw: shared["make"](kw, capture)  # noqa: E731
    out_off, st_off, _ = _shared_run(make, Request, False)
    out_on, st_on, eng = _shared_run(make, Request, True)
    r_out, r_st = shared["reference"]
    assert out_on == out_off == r_out
    pf = st_on["prefix"]
    assert pf["hits"] >= 1 and pf["cow_copies"] >= 1, pf
    assert pf["prefill_tokens_skipped"] == 24 * pf["hits"], pf
    assert pf == r_st["prefix"]
    assert st_off["prefix"]["hits"] == st_off["prefix"]["misses"] == 0
    # a hit runs no prefill
    assert st_on["admissions"] == st_off["admissions"] - pf["hits"]
    for seg in ("hi", "lo", "win"):
        assert {k: st_on[seg][k] for k in ("used", "outstanding")} == \
            {k: r_st[seg][k] for k in ("used", "outstanding")}
    if capture:
        assert eng.caches is eng._decode_masked.caches
        assert eng._decode_masked.captures == 1


def test_snapshot_is_untouched_and_pages_come_back(shared):
    """The snapshot a hit re-inserts is never written: after the run it is
    still bitwise a fresh prefill of the prompt.  Reclaiming the index
    returns every page and drops the snapshot."""
    _, _, eng = _shared_run(shared["make"], Request, True)
    (key, (snap, logits)), = eng._prefix_snap.items()
    with torch.inference_mode():
        want_logits, want = eng._prefill_for(24)(
            eng.params, {"tokens": torch.from_numpy(SHARED[None].copy())})
    assert torch.equal(logits, want_logits)
    for a, w in zip(_leaves(snap), _leaves(want)):
        assert torch.equal(a, w)
    used = eng.pool_stats()
    assert used["hi"]["used"] > 0 and used["prefix"]["entries"] == 1
    for k in eng._alloc.prefix_reclaim(min_pages=10**9):
        eng._prefix_snap.pop(k)
    assert not eng._prefix_snap
    eng._alloc.check_invariants()
    for seg in eng._alloc.segs.values():
        assert len(seg.free) == seg.pool_pages and not seg.refcount.any()


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def test_prefix_cache_needs_the_free_list(shared):
    for kw in (dict(backend="mixed"), dict(backend="paged")):
        with pytest.raises(ValueError, match="freelist"):
            shared["make"](dict(batch_size=2, prompt_len=32, max_new_tokens=12, page_size=8,
                                prefix_cache=True, **kw))
