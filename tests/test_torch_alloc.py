"""The port's free-list page allocator (`core/alloc.py`, a numpy copy) against
the JAX package's on the same seeded operation sequences: admissions under
admission control, decode appends, fold grants and shrinks, retirements.
Every page table, every statistic and every admission decision is equal,
and both sides' invariants hold after every operation."""

import numpy as np
import pytest

from repro.core import alloc as jalloc
from repro_torch.core import alloc


def _pair(slots, page, fraction, watermark):
    caps = (24, 36, 8)
    pools = tuple(max(int(np.ceil(slots * alloc.pages_for(c, page) * fraction)),
                      alloc.pages_for(c, page)) for c in caps)
    return (jalloc.FreeListAllocator(slots, page, caps, pools, watermark=watermark),
            alloc.FreeListAllocator(slots, page, caps, pools, watermark=watermark))


def _assert_same(j, t):
    for name in alloc.FreeListAllocator.SEGMENTS:
        np.testing.assert_array_equal(t.segs[name].table, j.segs[name].table, err_msg=name)
        assert t.segs[name].free == j.segs[name].free, name
    assert t.stats() == j.stats()
    assert t.occ == [None if o is None else alloc.Occupancy(o.hi, o.lo, o.win) for o in j.occ]
    assert t.admit_headroom() == j.admit_headroom()
    assert t.pool_pressure() == j.pool_pressure()
    j.check_invariants()
    t.check_invariants()


@pytest.mark.parametrize("slots,page,fraction,watermark",
                         [(2, 8, 0.75, 0.0), (3, 4, 0.6, 0.0), (4, 8, 1.0, 0.25), (3, 16, 0.5, 0.1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_matches_jax_on_random_sequences(slots, page, fraction, watermark, seed):
    rng = np.random.default_rng(seed)
    j, t = _pair(slots, page, fraction, watermark)
    budget = {}
    for _ in range(300):
        running = [s for s in range(slots) if t.occ[s] is not None]
        idle = [s for s in range(slots) if t.occ[s] is None]
        op = rng.choice(["admit", "append", "fold", "free"], p=[0.25, 0.5, 0.15, 0.1])
        if op == "admit" and idle:
            slot = int(rng.choice(idle))
            prompt = int(rng.integers(1, 48))
            total = prompt + int(rng.integers(1, 16))
            assert t.fits_ever(total, prompt) == j.fits_ever(total, prompt)
            assert t.worst_pages(total, prompt) == j.worst_pages(total, prompt)
            ok = t.can_admit(total, prompt)
            assert ok == j.can_admit(total, prompt)
            if not ok:
                t.deferrals += 1
                j.deferrals += 1
                continue
            n_hi = min(int(round(prompt * 0.4)), 24)
            occ = (n_hi, min(prompt - n_hi, 36), 0)
            j.admit(slot, jalloc.Occupancy(*occ), total, prompt)
            t.admit(slot, alloc.Occupancy(*occ), total, prompt)
            budget[slot] = total - prompt
        elif op == "append" and running:
            for slot in running:
                if budget[slot] == 0 or t.occ[slot].win >= t.window:
                    continue
                budget[slot] -= 1
                j.note_append(slot)
                t.note_append(slot)
        elif op == "fold" and running:
            slot = int(rng.choice(running))
            j.fold_grant(slot)
            t.fold_grant(slot)
            assert t.fold_shrink(slot) == j.fold_shrink(slot)
        elif op == "free" and running:
            slot = int(rng.choice(running))
            if rng.uniform() < 0.3:
                t.preemptions += 1
                j.preemptions += 1
            j.free(slot)
            t.free(slot)
        _assert_same(j, t)
        assert t.tables().keys() == j.tables().keys()


def test_exhausted_grant_raises_typed_error():
    _, t = _pair(2, 8, 0.5, 0.0)
    t.admit(0, alloc.Occupancy(3, 5, 0), 60, 48)
    with pytest.raises(alloc.PagePoolExhausted):
        t.admit(1, alloc.Occupancy(3, 5, 0), 60, 48)
    _, held_back = _pair(2, 8, 0.5, 0.5)   # half of each one-request pool held back
    assert not held_back.fits_ever(60, 48)
