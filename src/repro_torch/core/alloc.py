"""Free-list page allocator for the elastic paged layout (a host-only copy of
`repro.core.alloc`, numpy and the standard library only).

The static paged layout pre-assigns every slot its worst-case pages.  Here
each segment (hi store, lo store, staging window) has one shared POOL of
`pool_fraction` x that worst case plus a SINK page, and a free list of
physical page ids granted to slots on demand (admission, decode append,
window fold) and returned on retirement and fold.  Unallocated table
entries point at the sink (`NULL = pool_pages`): reads land on finite bytes
that every consumer masks, writes are absorbed.

Whole-page grants from token COUNTS alone are sound because
`compress_prefill` and `recompress` keep each store's valid tokens a
contiguous prefix (`kvcache._valid_first`).

Admission control: a request is admitted only when every segment can
reserve its WORST-CASE page demand (prompt + full decode budget) on top of
the running slots' outstanding reservations and the watermark, so later
grants never fail; pressure shows as deferred admission.

Left out of this copy until shared-prefix dedup is ported: `prefix_key`,
`PrefixIndex`, `alias`/`admit_alias`, `privatize` and the `prefix_*` calls.
Without aliasing every granted page is owned by exactly one slot, so
`needs_privatize` is False by construction, and the swap and downshift
refusals it guards cannot fire yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


class PagePoolExhausted(RuntimeError):
    """Typed backpressure signal: the page pool cannot cover a demand."""


class PoolCapacityError(ValueError):
    """A request's worst-case page demand exceeds the pool outright: it can
    never be admitted at this pool size (raised from `submit`)."""


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed for a contiguous prefix of `tokens` tokens."""
    return -(-tokens // page_size) if tokens > 0 else 0


@dataclasses.dataclass(frozen=True)
class Occupancy:
    """Valid-token counts per segment for one slot (window = fill cursor)."""
    hi: int
    lo: int
    win: int


def fold_occupancy(occ: Occupancy, s_hi: int, s_lo: int) -> Occupancy:
    """Post-recompression occupancy (mirror of `kvcache._recompress_all`):
    hi takes the top `s_hi` valid tokens, lo the next `s_lo`."""
    total = occ.hi + occ.lo + occ.win
    hi = min(total, s_hi)
    lo = min(total - hi, s_lo)
    return Occupancy(hi=hi, lo=lo, win=0)


def kv_elements(caches) -> list:
    """Every KV cache element of an engine's cache tree, in layer order."""
    from repro_torch.core import backend as backend_lib
    return backend_lib.kv_elements(caches)


def slice_occupancy(caches) -> Occupancy:
    """Per-segment valid-token counts of a batch-1 prefill slice (identical
    across layers, so the first element stands for all): one small host read
    of three rows per admission."""
    el = kv_elements(caches)[0]
    return Occupancy(hi=int((el.hi.pos[0] >= 0).sum()), lo=int((el.lo.pos[0] >= 0).sum()),
                     win=int(el.win_fill[0]))


@dataclasses.dataclass
class _Segment:
    """Free-list state for one page pool (hi store, lo store, or window)."""

    name: str
    capacity: int                 # token capacity of the segment
    page_size: int
    pool_pages: int               # usable pages (the sink is extra)
    free: List[int] = dataclasses.field(default_factory=list)
    table: Optional[np.ndarray] = None    # (slots, npp) int32; NULL == pool_pages
    granted: Optional[np.ndarray] = None  # (slots,) granted page counts
    worst: Optional[np.ndarray] = None    # (slots,) reserved worst-case pages
    refcount: Optional[np.ndarray] = None  # (pool_pages,) table references
    peak_used: int = 0

    @property
    def npp(self) -> int:
        return pages_for(self.capacity, self.page_size)

    @property
    def null(self) -> int:
        return self.pool_pages

    @property
    def used(self) -> int:
        return self.pool_pages - len(self.free)

    @property
    def outstanding(self) -> int:
        """Pages reserved for running slots but not yet drawn from the pool."""
        return int(np.maximum(self.worst - self.granted, 0).sum())

    def headroom(self, watermark: int) -> int:
        return len(self.free) - self.outstanding - watermark

    def grant(self, slot: int, n_pages: int) -> bool:
        """Grant logical pages [granted, n_pages) to `slot`.  True iff the
        table changed (a decode step that needs no page must not dirty it)."""
        cur = int(self.granted[slot])
        if n_pages <= cur:
            return False
        if n_pages - cur > len(self.free):
            raise PagePoolExhausted(
                f"segment {self.name!r}: need {n_pages - cur} pages for slot {slot}, free list "
                f"holds {len(self.free)} of {self.pool_pages} — admission control should have "
                "prevented this")
        for j in range(cur, n_pages):
            p = self.free.pop()
            assert self.refcount[p] == 0, f"{self.name}: free-list page {p} still referenced"
            self.table[slot, j] = p
            self.refcount[p] = 1
        self.granted[slot] = n_pages
        self.peak_used = max(self.peak_used, self.used)
        return True

    def shrink(self, slot: int, n_pages: int) -> bool:
        """Return the slot's logical pages [n_pages, granted) to the pool.
        True iff the table changed."""
        cur = int(self.granted[slot])
        if n_pages >= cur:
            return False
        for j in range(n_pages, cur):
            p = int(self.table[slot, j])
            assert self.refcount[p] == 1, f"{self.name}: shrink of unreferenced page {p}"
            self.refcount[p] = 0
            self.free.append(p)
            self.table[slot, j] = self.null
        self.granted[slot] = n_pages
        return True


class FreeListAllocator:
    """Host-side page bookkeeping for one engine's paged caches.  The engine
    installs `tables()` onto the device caches whenever `dirty`."""

    SEGMENTS = ("hi", "lo", "win")

    def __init__(self, slots: int, page_size: int, capacities: Tuple[int, int, int],
                 pool_pages: Tuple[int, int, int], watermark: float = 0.0):
        self.slots = slots
        self.page_size = page_size
        self.s_hi, self.s_lo, self.window = capacities
        self.segs: Dict[str, _Segment] = {}
        for name, cap, pool in zip(self.SEGMENTS, capacities, pool_pages):
            seg = _Segment(name=name, capacity=cap, page_size=page_size, pool_pages=pool)
            seg.free = list(range(pool))[::-1]  # LIFO: low ids granted first
            seg.table = np.full((slots, seg.npp), seg.null, np.int32)
            seg.granted = np.zeros(slots, np.int64)
            seg.worst = np.zeros(slots, np.int64)
            seg.refcount = np.zeros(pool, np.int64)
            self.segs[name] = seg
        self.occ: List[Optional[Occupancy]] = [None] * slots
        self.watermark = watermark
        self.deferrals = 0
        self.preemptions = 0   # evictions (recompute or swap), each a full free
        # the downshift ladder: early folds at a lowered lo-store width, the
        # window pages they returned, and victims refused for aliased pages
        self.downshifts = 0
        self.downshift_pages_freed = 0
        self.downshift_refusals = 0
        self.dirty = True

    @classmethod
    def from_caches(cls, caches, page_size: int, watermark: float = 0.0) -> "FreeListAllocator":
        """Read slot count, capacities and pool sizes off an initialized
        free-list cache tree."""
        el = kv_elements(caches)[0]

        def pool_of(null_page, pages):
            if null_page is None:
                return 0
            assert pages.shape[0] == null_page + 1, "free-list pools carry exactly one sink page"
            return int(null_page)

        caps = (int(el.hi.pos.shape[-1]), int(el.lo.pos.shape[-1]), int(el.win_pos.shape[-1]))
        pools = (pool_of(el.hi.null_page, el.hi.k_pages), pool_of(el.lo.null_page, el.lo.k_pages),
                 pool_of(el.win_null_page, el.win_k_pages))
        return cls(int(el.length.shape[-1]), page_size, caps, pools, watermark=watermark)

    # -- admission-control queries ------------------------------------------

    def worst_pages(self, total_tokens: int, prompt_tokens: Optional[int] = None) -> Dict[str, int]:
        """Worst-case per-segment page demand of a request whose cache can grow
        to `total_tokens` (prompt + full decode budget).  After any fold the
        stores follow the hi-first `fold_occupancy` clamp; right after the
        prefill the lo store can hold up to min(prompt, s_lo) tokens.  The
        window term is what the fill cursor can touch before a fold."""
        if prompt_tokens is None:
            prompt_tokens = total_tokens
        hi = min(total_tokens, self.s_hi)
        lo = max(min(max(total_tokens - self.s_hi, 0), self.s_lo), min(prompt_tokens, self.s_lo))
        return {"hi": pages_for(hi, self.page_size), "lo": pages_for(lo, self.page_size),
                "win": pages_for(min(total_tokens, self.window), self.page_size)}

    def _watermark_pages(self, seg: _Segment) -> int:
        return int(np.ceil(self.watermark * seg.pool_pages))

    def admit_headroom(self) -> Dict[str, int]:
        """Per-segment pages available to new reservations right now."""
        return {n: self.segs[n].headroom(self._watermark_pages(self.segs[n]))
                for n in self.SEGMENTS}

    def can_admit(self, total_tokens: int, prompt_tokens: Optional[int] = None) -> bool:
        worst = self.worst_pages(total_tokens, prompt_tokens)
        head = self.admit_headroom()
        return all(head[n] >= worst[n] for n in self.SEGMENTS)

    def fits_ever(self, total_tokens: int, prompt_tokens: Optional[int] = None) -> bool:
        """False when the request exceeds the pool even on an idle engine."""
        worst = self.worst_pages(total_tokens, prompt_tokens)
        return all(self.segs[n].pool_pages - self._watermark_pages(self.segs[n]) >= worst[n]
                   for n in self.SEGMENTS)

    # -- lifecycle mutations -------------------------------------------------

    def admit(self, slot: int, occ: Occupancy, total_tokens: int,
              prompt_tokens: Optional[int] = None) -> None:
        """Reserve the slot's worst case and grant its prefill pages."""
        assert self.occ[slot] is None, f"slot {slot} already occupied"
        worst = self.worst_pages(total_tokens, prompt_tokens)
        for name, n in (("hi", occ.hi), ("lo", occ.lo), ("win", occ.win)):
            if pages_for(n, self.page_size) > worst[name]:
                raise PagePoolExhausted(
                    f"segment {name!r}: prefill occupancy {n} tokens exceeds the modeled worst "
                    f"case {worst[name]} pages (total={total_tokens}, prompt={prompt_tokens})")
            if self.segs[name].headroom(0) < worst[name]:
                raise PagePoolExhausted(f"segment {name!r} cannot reserve {worst[name]} pages "
                                        f"for slot {slot}: {self.stats()[name]}")
        for name, n in (("hi", occ.hi), ("lo", occ.lo), ("win", occ.win)):
            seg = self.segs[name]
            seg.worst[slot] = worst[name]
            seg.grant(slot, pages_for(n, self.page_size))
        self.occ[slot] = occ
        self.dirty = True

    def note_append(self, slot: int) -> None:
        """One decode append: grant the window page under the write cursor if
        the slot does not hold it yet (dirties the tables only then)."""
        occ = self.occ[slot]
        assert occ is not None, f"append into unoccupied slot {slot}"
        if occ.win < self.window:
            if self.segs["win"].grant(slot, pages_for(occ.win + 1, self.page_size)):
                self.dirty = True
        self.occ[slot] = dataclasses.replace(occ, win=occ.win + 1)

    def pool_pressure(self) -> float:
        """Min free fraction across the non-empty pools (1.0 = all idle)."""
        fracs = [len(seg.free) / seg.pool_pages for seg in self.segs.values() if seg.pool_pages]
        return min(fracs) if fracs else 1.0

    def note_downshift(self, slot: int, pages_freed: int) -> None:
        """Account one ladder downshift of `slot`: its window was early-folded
        at a lowered lo-store width and `pages_freed` window pages came back
        (the returns themselves went through `fold_shrink`)."""
        assert self.occ[slot] is not None, f"downshift of unoccupied slot {slot}"
        self.downshifts += 1
        self.downshift_pages_freed += int(pages_freed)

    def note_downshift_refusal(self) -> None:
        """Account a victim skipped because its tables alias shared pages."""
        self.downshift_refusals += 1

    def needs_privatize(self, slot: int) -> bool:
        """Whether the slot's tables hold a page it does not own (a shared
        prefix page) that a fold would write through.  No page is shared
        without prefix dedup, so False."""
        return False

    def fold_grant(self, slot: int) -> None:
        """BEFORE a recompression: grant the hi/lo growth pages the fold will
        write (predicted by `fold_occupancy`)."""
        occ = self.occ[slot]
        assert occ is not None, f"fold of unoccupied slot {slot}"
        new = fold_occupancy(occ, self.s_hi, self.s_lo)
        grew = self.segs["hi"].grant(slot, pages_for(new.hi, self.page_size))
        grew |= self.segs["lo"].grant(slot, pages_for(new.lo, self.page_size))
        self.occ[slot] = dataclasses.replace(new, win=occ.win)
        self.dirty |= grew

    def fold_shrink(self, slot: int) -> int:
        """AFTER a recompression: the window emptied; return its pages.
        Returns how many came back."""
        occ = self.occ[slot]
        assert occ is not None
        returned = int(self.segs["win"].granted[slot])
        self.dirty |= self.segs["win"].shrink(slot, 0)
        self.occ[slot] = dataclasses.replace(occ, win=0)
        return returned

    def free(self, slot: int) -> None:
        """Retire a slot: return every granted page, drop its reservation."""
        for seg in self.segs.values():
            self.dirty |= seg.shrink(slot, 0)
            seg.worst[slot] = 0
        self.occ[slot] = None

    # -- engine integration ---------------------------------------------------

    def tables(self) -> Dict[str, np.ndarray]:
        """Current (slots, npp) page tables per segment (host copies)."""
        return {n: self.segs[n].table.copy() for n in self.SEGMENTS}

    def stats(self) -> Dict:
        out: Dict = {n: {"pool_pages": seg.pool_pages, "used": seg.used, "free": len(seg.free),
                         "peak_used": seg.peak_used, "outstanding": seg.outstanding}
                     for n, seg in self.segs.items()}
        out["deferrals"] = self.deferrals
        out["preemptions"] = self.preemptions
        out["downshift"] = {"downshifts": self.downshifts,
                            "pages_freed": self.downshift_pages_freed,
                            "refusals": self.downshift_refusals}
        return out

    def check_invariants(self) -> None:
        """Every pool page is on the free list (referenced by nothing) XOR
        referenced by exactly one granted table entry; granted prefixes are
        contiguous; free lists cover outstanding reservations."""
        for seg in self.segs.values():
            refs: Dict[int, int] = {}
            for s in range(self.slots):
                row = seg.table[s]
                g = int(seg.granted[s])
                assert (row[g:] == seg.null).all(), f"{seg.name}: slot {s} table past its grant"
                assert (row[:g] != seg.null).all(), f"{seg.name}: NULL inside slot {s} grant"
                for p in row[:g]:
                    refs[int(p)] = refs.get(int(p), 0) + 1
            free_set = set(seg.free)
            assert len(free_set) == len(seg.free), f"{seg.name}: duplicate page on the free list"
            for p in range(seg.pool_pages):
                rc = int(seg.refcount[p])
                if p in free_set:
                    assert rc == 0 and p not in refs, f"{seg.name}: free page {p} referenced"
                else:
                    assert rc == 1 and refs.get(p, 0) == 1, \
                        f"{seg.name}: page {p} refcount {rc}, {refs.get(p, 0)} references"
            assert len(seg.free) >= seg.outstanding, \
                f"{seg.name}: free list cannot cover outstanding reservations"
