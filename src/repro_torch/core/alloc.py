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

Shared-prefix dedup (copy-on-write): every pool page carries a REFCOUNT,
so one immutable page can back several slots' tables.  The prefix index
maps a page-granular chain hash of an admitted prompt bucket (`prefix_key`)
to the hi/lo pages its prefill produced; a later identical prompt is
admitted by ALIAS (`admit_alias`): its table rows point at those pages, the
refcounts rise, and its prefill is skipped.  Recompression re-splits hi/lo
per slot, so before a fold writes a slot that does not own all its pages
the engine calls `privatize`, which gives the slot fresh pages and returns
the page copies to issue on the device.  A slot's pages count toward its
reservation only while it OWNS them, so a slot that may still privatize
keeps its worst case outstanding.

One guard goes beyond the reference: `note_append` asserts that a slot
never caches more tokens than the total it was admitted with (prompt
bucket + decode budget), the contract every reservation rests on.  The
engine retires a request at its budget, so it never trips there.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
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


def prefix_key(tokens, page_size: int, padded_len: int) -> str:
    """Content chain hash of a prompt: left-padded (as admission packs it) to
    `padded_len`, the page-aligned admission bucket, and hashed one
    page-sized block at a time, each block's sha256 chained onto the last.
    Two prompts share a key iff their padded token arrays are equal, and
    then their prefills are bitwise equal too."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    if toks.shape[0] > padded_len:
        raise ValueError(f"prompt of {toks.shape[0]} tokens exceeds its padded bucket "
                         f"{padded_len}")
    padded = np.zeros(padded_len, np.int32)
    if toks.shape[0]:
        padded[padded_len - toks.shape[0]:] = toks
    h = hashlib.sha256(f"prefix:{page_size}:{padded_len}".encode())
    for start in range(0, padded_len, page_size):
        h = hashlib.sha256(h.digest() + padded[start:start + page_size].tobytes())
    return h.hexdigest()


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


def _first_kv_element(caches):
    """The first KV element, which stands for every layer's page demand.  A
    model with no attention layer (mamba2) has none: it holds no pages, so
    the free list has nothing to allocate (the reference fails here with an
    IndexError)."""
    els = kv_elements(caches)
    if not els:
        raise ValueError("the page allocator needs a KV cache, and this model has no "
                         "attention layer: serve it on the mixed or the paged static layout")
    return els[0]


def slice_occupancy(caches) -> Occupancy:
    """Per-segment valid-token counts of a batch-1 prefill slice (identical
    across layers, so the first element stands for all): one small host read
    of three rows per admission."""
    el = _first_kv_element(caches)
    return Occupancy(hi=int((el.hi.pos[0] >= 0).sum()), lo=int((el.lo.pos[0] >= 0).sum()),
                     win=int(el.win_fill[0]))


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix: the immutable hi/lo pages its prefill produced.
    The index holds one reference on each, so they outlive the donor slot;
    `occ` is the prefill occupancy an alias inherits (window pages are not
    shared: an alias gets fresh ones)."""
    key: str
    pages: Dict[str, List[int]]      # segment -> page ids (hi, lo)
    occ: Occupancy
    hits: int = 0


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
    refcount: Optional[np.ndarray] = None  # (pool_pages,) table + index references
    # owned[slot, j]: logical page j was drawn from the slot's own
    # reservation.  False for an aliased page, which the slot may still have
    # to replace by a fresh one (privatize), so its reservation stays out.
    owned: Optional[np.ndarray] = None     # (slots, npp) bool
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
        """Pages reserved for running slots but not yet drawn from the pool:
        only OWNED pages count as drawn."""
        return int(np.maximum(self.worst - self.owned.sum(axis=1), 0).sum())

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
            # a page on the free list is referenced by nothing: shrink and
            # free null the entry and drop the count before returning it, so
            # a page freed and re-granted in one step never sits in two tables
            assert self.refcount[p] == 0, (
                f"{self.name}: free-list page {p} still referenced (refcount "
                f"{int(self.refcount[p])}) — stale table entry")
            self.table[slot, j] = p
            self.refcount[p] = 1
            self.owned[slot, j] = True
        self.granted[slot] = n_pages
        self.peak_used = max(self.peak_used, self.used)
        return True

    def alias(self, slot: int, page_ids: List[int]) -> bool:
        """Point an empty table row at EXISTING pages (a prefix hit): the
        refcounts rise, the free list is untouched, and the pages stay
        un-owned until `privatize`."""
        cur = int(self.granted[slot])
        assert cur == 0, f"{self.name}: alias into slot {slot} with {cur} pages granted"
        for j, p in enumerate(page_ids):
            assert self.refcount[p] >= 1, f"{self.name}: alias of unreferenced page {p}"
            self.table[slot, j] = p
            self.refcount[p] += 1
            self.owned[slot, j] = False
        self.granted[slot] = len(page_ids)
        return bool(page_ids)

    def shrink(self, slot: int, n_pages: int) -> bool:
        """Return the slot's logical pages [n_pages, granted): a page goes back
        to the free list when its last reference goes.  True iff the table
        changed."""
        cur = int(self.granted[slot])
        if n_pages >= cur:
            return False
        for j in range(n_pages, cur):
            p = int(self.table[slot, j])
            assert self.refcount[p] >= 1, f"{self.name}: shrink of unreferenced page {p}"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.free.append(p)
            self.table[slot, j] = self.null
            self.owned[slot, j] = False
        self.granted[slot] = n_pages
        return True


class FreeListAllocator:
    """Host-side page bookkeeping for one engine's paged caches.  The engine
    installs `tables()` onto the device caches whenever `dirty`."""

    SEGMENTS = ("hi", "lo", "win")
    # index pages live in the two quantized stores only: the window is
    # written from the first decode append, so aliases never share it
    PREFIX_SEGMENTS = ("hi", "lo")

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
            seg.owned = np.zeros((slots, seg.npp), bool)
            self.segs[name] = seg
        self.occ: List[Optional[Occupancy]] = [None] * slots
        # the total each slot was admitted with (prompt bucket + budget)
        self.admitted_total: List[Optional[int]] = [None] * slots
        self.watermark = watermark
        self.deferrals = 0
        self.preemptions = 0   # evictions (recompute or swap), each a full free
        # the downshift ladder: early folds at a lowered lo-store width, the
        # window pages they returned, and victims refused for aliased pages
        self.downshifts = 0
        self.downshift_pages_freed = 0
        self.downshift_refusals = 0
        # shared-prefix index, key -> PrefixEntry in LRU order (a hit moves
        # to the end; reclaim evicts from the front)
        self.prefix: "collections.OrderedDict[str, PrefixEntry]" = collections.OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        self.cow_copies = 0
        self.dirty = True

    @classmethod
    def from_caches(cls, caches, page_size: int, watermark: float = 0.0) -> "FreeListAllocator":
        """Read slot count, capacities and pool sizes off an initialized
        free-list cache tree.  ValueError for a tree without a KV element."""
        el = _first_kv_element(caches)

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
        self.admitted_total[slot] = total_tokens
        self.dirty = True

    def admit_alias(self, slot: int, key: str, total_tokens: int,
                    prompt_tokens: Optional[int] = None, can_fold: bool = True) -> PrefixEntry:
        """Admit a prefix HIT: the slot's hi/lo rows alias the entry's pages
        (prefill skipped); only window pages are drawn.  `can_fold=False`
        (the budget ends before the first fold) reserves no hi/lo pages: the
        slot never writes those stores.  Otherwise the full worst case is
        reserved, which the first fold's privatize and growth draw from."""
        assert self.occ[slot] is None, f"slot {slot} already occupied"
        entry = self.prefix[key]
        worst = self.worst_pages(total_tokens, prompt_tokens)
        if not can_fold:
            worst = {**worst, "hi": 0, "lo": 0}
        for name in self.SEGMENTS:
            if self.segs[name].headroom(0) < worst[name]:
                raise PagePoolExhausted(f"segment {name!r} cannot reserve {worst[name]} pages "
                                        f"for aliased slot {slot}: {self.stats()[name]}")
        for name in self.SEGMENTS:
            self.segs[name].worst[slot] = worst[name]
        for name in self.PREFIX_SEGMENTS:
            self.segs[name].alias(slot, entry.pages[name])
        self.segs["win"].grant(slot, pages_for(entry.occ.win, self.page_size))
        self.occ[slot] = entry.occ
        self.admitted_total[slot] = total_tokens
        entry.hits += 1
        self.prefix_hits += 1
        self.prefix.move_to_end(key)
        self.dirty = True
        return entry

    def note_append(self, slot: int) -> None:
        """One decode append: grant the window page under the write cursor if
        the slot does not hold it yet (dirties the tables only then)."""
        occ = self.occ[slot]
        assert occ is not None, f"append into unoccupied slot {slot}"
        total = self.admitted_total[slot]
        assert occ.hi + occ.lo + occ.win < total, (
            f"note_append: slot {slot} already caches {occ.hi + occ.lo + occ.win} tokens, its "
            f"admitted total {total}; an append past it overdraws the reservation")
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
        """True if the slot's tables hold a page it does not own: the engine
        must `privatize` before a fold writes through them."""
        for seg in self.segs.values():
            g = int(seg.granted[slot])
            if g and not seg.owned[slot, :g].all():
                return True
        return False

    def privatize(self, slot: int) -> Dict[str, Tuple[List[int], List[int]]]:
        """Copy-on-write: give the slot its OWN page for every aliased entry.
        A page still shared (refcount > 1) is swapped for a fresh one from
        the free list, and {segment: (src_ids, dst_ids)} lists the page
        copies to issue on the device before anything reads through the new
        table; a page whose other referents are gone is adopted in place.
        Draws are covered by the slot's reservation (aliased pages never
        counted as drawn)."""
        moves: Dict[str, Tuple[List[int], List[int]]] = {}
        for name, seg in self.segs.items():
            src: List[int] = []
            dst: List[int] = []
            for j in range(int(seg.granted[slot])):
                if seg.owned[slot, j]:
                    continue
                p = int(seg.table[slot, j])
                if seg.refcount[p] == 1:
                    seg.owned[slot, j] = True     # sole referent: adopt in place
                    continue
                if not seg.free:
                    raise PagePoolExhausted(
                        f"segment {name!r}: no free page to privatize slot {slot} page {p} — "
                        "reservation accounting broken")
                q = seg.free.pop()
                assert seg.refcount[q] == 0, f"{name}: free-list page {q} still referenced"
                seg.refcount[p] -= 1
                seg.refcount[q] = 1
                seg.table[slot, j] = q
                seg.owned[slot, j] = True
                seg.peak_used = max(seg.peak_used, seg.used)
                src.append(p)
                dst.append(q)
            if src:
                moves[name] = (src, dst)
                self.cow_copies += len(src)
                self.dirty = True
        return moves

    def fold_grant(self, slot: int) -> None:
        """BEFORE a recompression: grant the hi/lo growth pages the fold will
        write (predicted by `fold_occupancy`).  The slot must own every
        page: a fold re-splits hi/lo per slot, and writing through an
        aliased page would corrupt its other referents."""
        occ = self.occ[slot]
        assert occ is not None, f"fold of unoccupied slot {slot}"
        for name in self.PREFIX_SEGMENTS:
            seg = self.segs[name]
            g = int(seg.granted[slot])
            assert not g or seg.owned[slot, :g].all(), (
                f"{name}: fold_grant on slot {slot} with aliased pages — privatize before "
                "folding")
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
        self.admitted_total[slot] = None

    # -- shared-prefix index --------------------------------------------------

    def prefix_peek(self, key: str) -> Optional[PrefixEntry]:
        """The entry for `key` or None; no counters, no LRU move (admission
        planning probes a request many times)."""
        return self.prefix.get(key)

    def prefix_register(self, key: str, slot: int) -> bool:
        """Index the freshly admitted slot's hi/lo pages under `key`.  The
        index takes one reference on each and the donor's ownership is
        rescinded (its first fold privatizes like any alias), which raises
        its outstanding reservation by its prefill pages.  Refused (False)
        when a free list cannot cover that, or the key is indexed already."""
        if key in self.prefix:
            return False
        for name in self.PREFIX_SEGMENTS:
            seg = self.segs[name]
            delta = int(seg.owned[slot, :int(seg.granted[slot])].sum())
            if len(seg.free) < seg.outstanding + delta:
                return False
        pages: Dict[str, List[int]] = {}
        for name in self.PREFIX_SEGMENTS:
            seg = self.segs[name]
            g = int(seg.granted[slot])
            ids = [int(p) for p in seg.table[slot, :g]]
            for p in ids:
                seg.refcount[p] += 1
            seg.owned[slot, :g] = False
            pages[name] = ids
        self.prefix[key] = PrefixEntry(key=key, pages=pages, occ=self.occ[slot])
        self.prefix.move_to_end(key)
        return True

    def prefix_note_miss(self) -> None:
        self.prefix_misses += 1

    def _evict_entry(self, key: str) -> int:
        """Drop one entry; returns the pages that freed (pages still aliased
        by running slots stay until those retire)."""
        entry = self.prefix.pop(key)
        freed = 0
        for name in self.PREFIX_SEGMENTS:
            seg = self.segs[name]
            for p in entry.pages[name]:
                assert seg.refcount[p] >= 1, f"{name}: index page {p} unreferenced"
                seg.refcount[p] -= 1
                if seg.refcount[p] == 0:
                    seg.free.append(p)
                    freed += 1
        self.prefix_evictions += 1
        return freed

    def prefix_reclaim(self, min_pages: int = 1) -> List[str]:
        """Evict least-recently-used entries until `min_pages` pages came back
        (or the index is empty).  Returns the evicted keys, whose snapshots
        the engine drops; tables are untouched."""
        evicted: List[str] = []
        freed = 0
        while self.prefix and freed < min_pages:
            key = next(iter(self.prefix))
            freed += self._evict_entry(key)
            evicted.append(key)
        return evicted

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
        # shared_pages: pages with more than one referent now; saved_pages:
        # the pages dedup is not spending now (sum of refcount - 1)
        shared = saved = 0
        for name in self.PREFIX_SEGMENTS:
            rc = self.segs[name].refcount
            shared += int((rc >= 2).sum())
            saved += int(np.maximum(rc - 1, 0).sum())
        out["prefix"] = {"entries": len(self.prefix), "hits": self.prefix_hits,
                         "misses": self.prefix_misses, "evictions": self.prefix_evictions,
                         "cow_copies": self.cow_copies, "shared_pages": shared,
                         "saved_pages": saved}
        return out

    def check_invariants(self) -> None:
        """The refcount partition: every pool page is on the free list
        (refcount 0, referenced by nothing) XOR its refcount equals the
        table entries plus index entries referencing it; granted prefixes
        are contiguous; an owned page has no other referent; free lists
        cover outstanding reservations."""
        for name, seg in self.segs.items():
            refs: Dict[int, int] = {}
            for s in range(self.slots):
                row = seg.table[s]
                g = int(seg.granted[s])
                assert (row[g:] == seg.null).all(), f"{name}: slot {s} table past its grant"
                assert (row[:g] != seg.null).all(), f"{name}: NULL inside slot {s} grant"
                assert not seg.owned[s, g:].any(), f"{name}: ownership past slot {s} grant"
                for j in range(g):
                    p = int(row[j])
                    refs[p] = refs.get(p, 0) + 1
                    if seg.owned[s, j]:
                        assert seg.refcount[p] == 1, (
                            f"{name}: slot {s} owns shared page {p} (refcount "
                            f"{int(seg.refcount[p])})")
            for entry in self.prefix.values():
                for p in entry.pages.get(name, ()):
                    refs[p] = refs.get(p, 0) + 1
            free_set = set(seg.free)
            assert len(free_set) == len(seg.free), f"{name}: duplicate page on the free list"
            for p in range(seg.pool_pages):
                rc = int(seg.refcount[p])
                if p in free_set:
                    assert rc == 0 and p not in refs, (
                        f"{name}: free page {p} still referenced (refcount {rc}, "
                        f"{refs.get(p, 0)} references)")
                else:
                    assert rc == refs.get(p, 0) and rc >= 1, (
                        f"{name}: page {p} refcount {rc} != {refs.get(p, 0)} references "
                        "(partition violated)")
            assert len(seg.free) >= seg.outstanding, \
                f"{name}: free list cannot cover outstanding reservations"
