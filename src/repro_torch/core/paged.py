"""Paged KV cache layout (port of `repro.core.paged`): the second backend.

The bulky payload (bit-packed hi/lo codes and the bf16 staging window)
lives in fixed-size pages of per-segment pools, `(n_pages, h_kv, page,
channels)`, and each batch slot addresses its pages through a page table
`(b, pages_per_slot)` int32.  The small metadata (per-token scales, channel
normalizers, positions, saliency state, counters) stays dense per slot.

Numerical contract, as in the reference: the logical dense view
(`dense_view`) evolves bit-identically to the mixed layout under the same
operations, so greedy engine output is token-identical across layouts.

Two table layouts:
  * static: slot s's j-th page is physical page `j*b + s` (strided, so
    nothing can shortcut the table);
  * free list: pools of `pool_fraction` x the static worst case plus one
    SINK page; unallocated entries point at the sink, and the host-side
    `core.alloc.FreeListAllocator` grants and returns pages between steps.

Unlike the reference's functional updates, the ops here write the page
POOLS in place (`append_token`, `insert_slot`, the recompression
write-backs): the cache owns its pools, and copying them on every decode
step would double the payload's traffic.  Metadata is still replaced, not
mutated, so an older cache object keeps its metadata but shares the
pools.  Pools are made with `torch.zeros`: a sink or stale page must decode
to finite values, since `0 * v` with an infinite v poisons the sum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import kvcache as kvc
from repro_torch.core import quant
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels import build

DEFAULT_PAGE_SIZE = 64


def n_pages(capacity: int, page_size: int) -> int:
    """Pages needed for `capacity` tokens (the last page may be partial)."""
    return -(-capacity // page_size) if capacity else 0


def _strided_table(b: int, npp: int, device=None) -> torch.Tensor:
    """Round-robin page assignment: slot s's j-th page is physical j*b + s."""
    return (torch.arange(npp, dtype=torch.int32, device=device)[None, :] * b
            + torch.arange(b, dtype=torch.int32, device=device)[:, None])


# ---------------------------------------------------------------------------
# Pool <-> dense-token-axis conversion
# ---------------------------------------------------------------------------

def _paginate(dense: torch.Tensor, page_size: int) -> torch.Tensor:
    """(b, h, S, c) -> (b, npp, h, page, c), zero-padding the token axis."""
    b, h, s, c = dense.shape
    npp = n_pages(s, page_size)
    x = torch.nn.functional.pad(dense, (0, 0, 0, npp * page_size - s))
    return x.reshape(b, h, npp, page_size, c).transpose(1, 2)


def _gather_dense(pages: torch.Tensor, table: torch.Tensor, capacity: int) -> torch.Tensor:
    """Pages (P, h, page, c) via table (b, npp) -> dense (b, h, capacity, c)."""
    b, npp = table.shape
    _, h, page, c = pages.shape
    g = pages[table.long()].transpose(1, 2)         # (b, h, npp, page, c)
    return g.reshape(b, h, npp * page, c)[:, :, :capacity]


def _scatter_dense(pages: torch.Tensor, table: torch.Tensor, dense: torch.Tensor,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write dense (b, h, S, c) into the pool at each slot's table pages, in
    place.  `rows`: optional (b,) bool; other rows rewrite what their pages
    hold (the reference drops their writes)."""
    if table.shape[1] == 0:
        return pages
    idx = table.long()
    upd = _paginate(dense.to(pages.dtype), pages.shape[2])
    if rows is not None:
        upd = torch.where(rows[:, None, None, None, None], upd, pages[idx])
    pages[idx] = upd
    return pages


# ---------------------------------------------------------------------------
# PagedStore / PagedKVCache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedStore:
    """One quantized token store, paged.  `k_meta`/`v_meta` are
    QuantizedTensors with codes=None (the codes live in the pools);
    `null_page` is the free-list layout's sink id (None: static layout)."""

    k_pages: torch.Tensor          # (P, h_kv, page, ck)
    v_pages: torch.Tensor          # (P, h_kv, page, cv)
    table: torch.Tensor            # (b, npp) int32
    k_meta: quant.QuantizedTensor
    v_meta: quant.QuantizedTensor
    pos: torch.Tensor              # (b, S) int32, -1 = empty
    acc: torch.Tensor              # (b, S) f32
    nnz: torch.Tensor              # (b, S) f32
    null_page: Optional[int] = None

    @property
    def capacity(self) -> int:
        return self.pos.shape[-1]

    @property
    def valid(self) -> torch.Tensor:
        return self.pos >= 0

    def dense(self) -> kvc.TokenStore:
        """Gather pages back into the logical `TokenStore` (exact layout)."""
        k = dataclasses.replace(self.k_meta, codes=_gather_dense(
            self.k_pages, self.table, self.k_meta.shape[-2]))
        v = dataclasses.replace(self.v_meta, codes=_gather_dense(
            self.v_pages, self.table, self.v_meta.shape[-2]))
        return kvc.TokenStore(k, v, self.pos, self.acc, self.nnz)

    def _n_pages(self) -> int:
        return int(self.k_pages.shape[0])

    def _page_nbytes(self) -> int:
        n = self._n_pages()
        return sum(p.numel() // n * p.element_size()
                   for p in (self.k_pages, self.v_pages)) if n else 0

    def _live_pages(self) -> int:
        """Pages some slot's table references (a host read of the table in
        the free-list layout; every pool page in the static one)."""
        if self.null_page is None:
            return self._n_pages()
        return int((torch.unique(self.table.cpu()) < self.null_page).sum())

    def nbytes_packed(self) -> int:
        """Live payload pages + quantization parameters (page-granular)."""
        n = self._live_pages() * self._page_nbytes()
        return n + sum(t.numel() * t.element_size() for meta in (self.k_meta, self.v_meta)
                       for t in (meta.scale, meta.zero, meta.channel_scale) if t is not None)

    def nbytes_free_pool(self) -> int:
        return (self._n_pages() - self._live_pages()) * self._page_nbytes()


@dataclasses.dataclass
class PagedKVCache:
    """Paged mixed-precision KV cache.  Field names mirror `MixedKVCache`, so
    the metadata-only ops of `core.kvcache` (`update_probe_state`,
    `free_slot`) apply to it unchanged."""

    hi: PagedStore
    lo: PagedStore
    win_k_pages: torch.Tensor      # (P_w, h_kv, page, d) raw staging pages
    win_v_pages: torch.Tensor
    win_table: torch.Tensor        # (b, npp_w) int32
    win_pos: torch.Tensor          # (b, W) int32, -1 empty
    win_acc: torch.Tensor          # (b, W) f32
    win_nnz: torch.Tensor          # (b, W) f32
    length: torch.Tensor           # (b,) int32
    win_fill: torch.Tensor         # (b,) int32
    win_null_page: Optional[int] = None

    @property
    def page_size(self) -> int:
        return self.win_k_pages.shape[2]

    @property
    def window(self) -> int:
        return self.win_pos.shape[-1]

    @property
    def capacity(self) -> int:
        return self.hi.capacity + self.lo.capacity + self.window

    def dense_view(self) -> kvc.MixedKVCache:
        """Gather all pages into the equivalent `MixedKVCache` (bit-exact)."""
        w = self.window
        return kvc.MixedKVCache(
            hi=self.hi.dense(), lo=self.lo.dense(),
            k_win=_gather_dense(self.win_k_pages, self.win_table, w),
            v_win=_gather_dense(self.win_v_pages, self.win_table, w),
            win_pos=self.win_pos, win_acc=self.win_acc, win_nnz=self.win_nnz,
            length=self.length, win_fill=self.win_fill)

    def _win_page_nbytes(self) -> int:
        n = int(self.win_k_pages.shape[0])
        return sum(t.numel() // n * t.element_size()
                   for t in (self.win_k_pages, self.win_v_pages)) if n else 0

    def _win_live_pages(self) -> int:
        if self.win_null_page is None:
            return int(self.win_k_pages.shape[0])
        return int((torch.unique(self.win_table.cpu()) < self.win_null_page).sum())

    def nbytes_packed(self) -> int:
        return (self.hi.nbytes_packed() + self.lo.nbytes_packed()
                + self._win_live_pages() * self._win_page_nbytes())

    def nbytes_free_pool(self) -> int:
        """Bytes of unallocated pages (free list + sink) across the pools."""
        return (self.hi.nbytes_free_pool() + self.lo.nbytes_free_pool()
                + (int(self.win_k_pages.shape[0]) - self._win_live_pages())
                * self._win_page_nbytes())

    def nbytes_total(self) -> int:
        return sum(t.numel() * t.element_size() for t in kvc.tree_leaves(self))

    def nbytes_overhead(self) -> int:
        """Page tables + positions/saliency/counters + free-pool pages."""
        return self.nbytes_total() - self.nbytes_packed()


def _pool_of(dense: torch.Tensor, page_size: int, table: torch.Tensor) -> torch.Tensor:
    """A pool holding each slot's pages of dense (b, h, S, c) at its table ids."""
    b, npp = table.shape
    paged = _paginate(dense, page_size)                 # (b, npp, h, page, c)
    pool = torch.zeros((b * npp, *paged.shape[2:]), dtype=dense.dtype, device=dense.device)
    if npp:
        pool[table.long()] = paged
    return pool


def _store_from_token_store(ts: kvc.TokenStore, page_size: int,
                            table: torch.Tensor) -> PagedStore:
    return PagedStore(
        k_pages=_pool_of(ts.k.codes, page_size, table),
        v_pages=_pool_of(ts.v.codes, page_size, table), table=table,
        k_meta=dataclasses.replace(ts.k, codes=None), v_meta=dataclasses.replace(ts.v, codes=None),
        pos=ts.pos, acc=ts.acc, nnz=ts.nnz)


def from_mixed(mx: kvc.MixedKVCache, page_size: int = DEFAULT_PAGE_SIZE,
               tables: Optional[Tuple[torch.Tensor, ...]] = None) -> PagedKVCache:
    """Pure layout conversion: page the payload, keep metadata dense.
    `tables`: optional (hi, lo, win) tables (default: strided round-robin)."""
    b = mx.length.shape[0]
    dev = mx.length.device
    if tables is None:
        tables = tuple(_strided_table(b, n_pages(c, page_size), dev)
                       for c in (mx.hi.capacity, mx.lo.capacity, mx.window))
    t_hi, t_lo, t_w = tables
    return PagedKVCache(
        hi=_store_from_token_store(mx.hi, page_size, t_hi),
        lo=_store_from_token_store(mx.lo, page_size, t_lo),
        win_k_pages=_pool_of(mx.k_win, page_size, t_w),
        win_v_pages=_pool_of(mx.v_win, page_size, t_w), win_table=t_w,
        win_pos=mx.win_pos, win_acc=mx.win_acc, win_nnz=mx.win_nnz,
        length=mx.length, win_fill=mx.win_fill)


def freelist_pool_pages(b: int, npp: int, fraction: float) -> int:
    """Usable pool pages under `pool_fraction`: that fraction of the static
    worst case, never below one full request's worth (`npp`)."""
    if npp == 0:
        return 0
    return max(int(np.ceil(b * npp * fraction)), npp)


def from_mixed_freelist(mx: kvc.MixedKVCache, page_size: int,
                        pool_pages: Tuple[int, int, int]) -> PagedKVCache:
    """EMPTY free-list cache shaped like `mx` (an `init_cache` result).
    Pools hold `pool_pages[i]` usable pages plus one sink page; every table
    entry starts at the sink id (`null_page`)."""
    base = from_mixed(mx, page_size)
    b = int(mx.length.shape[0])

    def pools(k_pages, v_pages, usable):
        shape = (usable + 1, *k_pages.shape[1:])
        return (torch.zeros(shape, dtype=k_pages.dtype, device=k_pages.device),
                torch.zeros((usable + 1, *v_pages.shape[1:]), dtype=v_pages.dtype,
                            device=v_pages.device))

    def table(npp, usable, dev):
        return torch.full((b, npp), usable, dtype=torch.int32, device=dev)

    def seg(store: PagedStore, usable: int) -> PagedStore:
        npp = store.table.shape[1]
        if npp == 0:
            return store
        k, v = pools(store.k_pages, store.v_pages, usable)
        return dataclasses.replace(store, k_pages=k, v_pages=v,
                                   table=table(npp, usable, k.device), null_page=usable)

    p_hi, p_lo, p_w = pool_pages
    out = dataclasses.replace(base, hi=seg(base.hi, p_hi), lo=seg(base.lo, p_lo))
    npp_w = base.win_table.shape[1]
    if npp_w == 0:
        return out
    k, v = pools(base.win_k_pages, base.win_v_pages, p_w)
    return dataclasses.replace(out, win_k_pages=k, win_v_pages=v,
                               win_table=table(npp_w, p_w, k.device), win_null_page=p_w)


def with_tables(cache: PagedKVCache, t_hi, t_lo, t_win) -> PagedKVCache:
    """Install allocator-made (slots, npp) page tables onto a cache element.
    Values only: shapes and dtypes are unchanged.  Callers installing onto
    many layers upload each table once and pass the device tensor."""
    def put(cur: torch.Tensor, new) -> torch.Tensor:
        if cur.shape[-1] == 0:
            return cur
        return torch.as_tensor(new, dtype=torch.int32, device=cur.device)

    return dataclasses.replace(
        cache, hi=dataclasses.replace(cache.hi, table=put(cache.hi.table, t_hi)),
        lo=dataclasses.replace(cache.lo, table=put(cache.lo.table, t_lo)),
        win_table=put(cache.win_table, t_win))


# ---------------------------------------------------------------------------
# Ops (decode append, slot insert, recompress write-back)
# ---------------------------------------------------------------------------

def append_token(cache: PagedKVCache, k_t: torch.Tensor, v_t: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Append one decoded token per slot into its current staging page.
    Bookkeeping is `kvcache.append_token`'s; the payload write resolves
    (slot, win_fill) through the page table and touches one page per slot.
    Rows that drop the write store back what the page holds there."""
    writes, slot, inc = kvc._append_cursor(cache, active)
    page = cache.page_size
    bidx = torch.arange(k_t.shape[0], device=k_t.device)
    phys = cache.win_table[bidx, slot // page].long()
    off = slot % page
    for pages, x in ((cache.win_k_pages, k_t), (cache.win_v_pages, v_t)):
        pages[phys, :, off] = torch.where(writes[:, None, None], x.to(pages.dtype),
                                          pages[phys, :, off])
    return dataclasses.replace(cache, **kvc._advance(cache, inc, writes, slot))


def _strip_store(s: PagedStore) -> PagedStore:
    return dataclasses.replace(s, k_pages=None, v_pages=None, table=None)


def _meta_only(cache: PagedKVCache) -> PagedKVCache:
    """The dense per-slot metadata: pools and tables removed."""
    return dataclasses.replace(cache, hi=_strip_store(cache.hi), lo=_strip_store(cache.lo),
                               win_k_pages=None, win_v_pages=None, win_table=None)


def _with_payload_of(meta: PagedKVCache, src: PagedKVCache) -> PagedKVCache:
    def attach(m, s):
        return dataclasses.replace(m, k_pages=s.k_pages, v_pages=s.v_pages, table=s.table)
    return dataclasses.replace(meta, hi=attach(meta.hi, src.hi), lo=attach(meta.lo, src.lo),
                               win_k_pages=src.win_k_pages, win_v_pages=src.win_v_pages,
                               win_table=src.win_table)


def _segments(cache: PagedKVCache):
    """(pool, table) of every payload segment, K and V."""
    return ((cache.hi.k_pages, cache.hi.table), (cache.hi.v_pages, cache.hi.table),
            (cache.lo.k_pages, cache.lo.table), (cache.lo.v_pages, cache.lo.table),
            (cache.win_k_pages, cache.win_table), (cache.win_v_pages, cache.win_table))


def insert_slot(dst: PagedKVCache, src: PagedKVCache, slot: int) -> PagedKVCache:
    """Write a 1-request cache `src` into batch slot `slot` of `dst`: src's
    logical pages go onto the physical pages the slot owns in dst's table
    (nothing else in the pools is touched); metadata are row writes."""
    for (d_pages, d_table), (s_pages, s_table) in zip(_segments(dst), _segments(src)):
        if d_table.shape[1]:
            d_pages[d_table[slot].long()] = s_pages[s_table[0].long()].to(d_pages.dtype)
    meta = kvc.tree_update_rows(_meta_only(dst), _meta_only(src), slot)
    return _with_payload_of(meta, dst)


def free_slot(cache: PagedKVCache, slot: int) -> PagedKVCache:
    """Retire a slot: invalidate its metadata rows.  Pages stay as they are
    (validity is pos-driven); under the free list the engine's allocator
    returns them and NULLs the slot's table row host-side."""
    return kvc.free_slot(cache, slot)


def copy_pages(cache: PagedKVCache, moves) -> PagedKVCache:
    """Copy physical pages inside each pool, in place: pages `src[i]` ->
    `dst[i]` per segment ("hi", "lo", "win"; moves[seg] = (src, dst) int64
    device vectors).  The device half of copy-on-write (`core.alloc`
    `privatize`): the allocator points a slot's table at fresh pages, and
    this fills them before anything reads through the new table.

    Every source page is gathered before any write.  The engine pads the id
    vectors with the segment's sink id: those sink -> sink copies write
    duplicate destinations with equal values.  Tables and metadata are
    untouched.  Writing the pools in place (the reference returns new ones)
    spares a copy of every pool into the decode step's static tree."""
    for name, pools in (("hi", (cache.hi.k_pages, cache.hi.v_pages)),
                        ("lo", (cache.lo.k_pages, cache.lo.v_pages)),
                        ("win", (cache.win_k_pages, cache.win_v_pages))):
        src, dst = moves[name]
        for pool in pools:
            if pool.shape[0]:
                pool.index_copy_(0, dst, pool.index_select(0, src))
    return cache


def _write_back(cache: PagedKVCache, mx: kvc.MixedKVCache,
                rows: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Scatter a recompressed dense cache back into the paged layout,
    restricted to `rows` when given (other slots keep pages and metadata)."""
    def seg(store: PagedStore, ts: kvc.TokenStore) -> PagedStore:
        _scatter_dense(store.k_pages, store.table, ts.k.codes, rows)
        _scatter_dense(store.v_pages, store.table, ts.v.codes, rows)
        return PagedStore(store.k_pages, store.v_pages, store.table,
                          dataclasses.replace(ts.k, codes=None),
                          dataclasses.replace(ts.v, codes=None),
                          ts.pos, ts.acc, ts.nnz, null_page=store.null_page)

    _scatter_dense(cache.win_k_pages, cache.win_table, mx.k_win, rows)
    _scatter_dense(cache.win_v_pages, cache.win_table, mx.v_win, rows)
    out = dataclasses.replace(
        cache, hi=seg(cache.hi, mx.hi), lo=seg(cache.lo, mx.lo), win_pos=mx.win_pos,
        win_acc=mx.win_acc, win_nnz=mx.win_nnz, length=mx.length, win_fill=mx.win_fill)
    if rows is None:
        return out
    return _with_payload_of(kvc.tree_select_rows(rows, _meta_only(out), _meta_only(cache)), out)


def recompress(cfg: CompressionConfig, cache: PagedKVCache, rows: Optional[torch.Tensor] = None,
               use_kernel: bool = False, eff=None) -> PagedKVCache:
    """Fold staging pages back into the stores (paper Alg. 3): the dense
    recompression on the gathered view, scattered back page-wise.  `eff`
    (a precision map, a downshift rung) passes through to the dense
    recompression: codes stay packed at the container width, so the page
    layout does not depend on it."""
    mx = kvc.recompress(cfg, cache.dense_view(), use_kernel=use_kernel, eff=eff)
    return _write_back(cache, mx, rows=rows)


def _slot_dense(pages: torch.Tensor, table: torch.Tensor, slot: int, n: int) -> torch.Tensor:
    """One slot's first `n` logical tokens of a pool: (1, h, n, c)."""
    logical = pages[table[slot].long()]                  # (npp, h, page, c)
    npp, h, page, c = logical.shape
    return logical.transpose(0, 1).reshape(1, h, npp * page, c)[:, :, :n]


def _slice_slot_view(cache: PagedKVCache, slot: int) -> kvc.MixedKVCache:
    """One slot's logical cache as a batch-1 dense `MixedKVCache`."""
    def row(x):
        return None if x is None else x[slot:slot + 1]

    def store(s: PagedStore) -> kvc.TokenStore:
        qts = [quant.QuantizedTensor(_slot_dense(pages, s.table, slot, meta.shape[-2]),
                                     row(meta.scale), row(meta.zero), row(meta.channel_scale),
                                     meta.bits, (1, *meta.shape[1:]))
               for pages, meta in ((s.k_pages, s.k_meta), (s.v_pages, s.v_meta))]
        return kvc.TokenStore(*qts, row(s.pos), row(s.acc), row(s.nnz))

    w = cache.window
    return kvc.MixedKVCache(
        hi=store(cache.hi), lo=store(cache.lo),
        k_win=_slot_dense(cache.win_k_pages, cache.win_table, slot, w),
        v_win=_slot_dense(cache.win_v_pages, cache.win_table, slot, w),
        win_pos=row(cache.win_pos), win_acc=row(cache.win_acc), win_nnz=row(cache.win_nnz),
        length=row(cache.length), win_fill=row(cache.win_fill))


def recompress_slot(cfg: CompressionConfig, cache: PagedKVCache, slot: int,
                    use_kernel: bool = False, eff=None) -> PagedKVCache:
    """Fold ONE slot's staging pages: recompress its batch-1 dense view and
    scatter the result onto the slot's pages and metadata row.  Bitwise
    `recompress(rows=onehot(slot))`, at per-request instead of batch cost.
    `eff` must be per-head or scalar shaped (the view is batch 1): a slot
    fold takes a scalar rung, not the (b,) batch rung."""
    mx1 = kvc.recompress(cfg, _slice_slot_view(cache, slot), use_kernel=use_kernel, eff=eff)

    def scat(pages, table, dense):
        if table.shape[1]:
            pages[table[slot].long()] = _paginate(dense.to(pages.dtype), pages.shape[2])[0]

    def seg(store: PagedStore, ts: kvc.TokenStore) -> PagedStore:
        scat(store.k_pages, store.table, ts.k.codes)
        scat(store.v_pages, store.table, ts.v.codes)
        src = dataclasses.replace(_strip_store(store), k_meta=dataclasses.replace(ts.k, codes=None),
                                  v_meta=dataclasses.replace(ts.v, codes=None),
                                  pos=ts.pos, acc=ts.acc, nnz=ts.nnz)
        meta = kvc.tree_update_rows(_strip_store(store), src, slot)
        return dataclasses.replace(meta, k_pages=store.k_pages, v_pages=store.v_pages,
                                   table=store.table)

    scat(cache.win_k_pages, cache.win_table, mx1.k_win)
    scat(cache.win_v_pages, cache.win_table, mx1.v_win)
    rowup = lambda d, s: kvc._row_set(d, slot, s[0].to(d.dtype))  # noqa: E731
    return dataclasses.replace(
        cache, hi=seg(cache.hi, mx1.hi), lo=seg(cache.lo, mx1.lo),
        win_pos=rowup(cache.win_pos, mx1.win_pos), win_acc=rowup(cache.win_acc, mx1.win_acc),
        win_nnz=rowup(cache.win_nnz, mx1.win_nnz), length=rowup(cache.length, mx1.length),
        win_fill=rowup(cache.win_fill, mx1.win_fill))


# ---------------------------------------------------------------------------
# Swap: one slot's state out to the host and back
# ---------------------------------------------------------------------------

def extract_slot(cache: PagedKVCache, slot: int) -> list:
    """One slot's complete device state, the device half of a swap-out
    (`core.swap` owns the host entries): the payload pages of each segment
    (`_segments` order) in LOGICAL order through the slot's table row,
    (npp, h, page, c) each, then the slot's metadata rows, (1, ...) each, as
    a flat list.

    Table entries past the granted prefix are NULL (the sink) and gather
    its bytes, harmless: validity is pos-driven, and `restore_slot`
    scatters those logical pages back into the sink.  The full npp extent
    keeps every shape fixed, so one host entry fits every occupancy."""
    pages = [pool[table[slot].long()] if table.shape[1] else pool[:0]
             for pool, table in _segments(cache)]
    return pages + [x[slot:slot + 1] for x in kvc.tree_leaves(_meta_only(cache))]


def payload_len(cache: PagedKVCache) -> int:
    """How many tensors `extract_slot` gives for one slot of `cache`."""
    return len(_segments(cache)) + sum(1 for _ in kvc.tree_leaves(_meta_only(cache)))


def restore_slot(cache: PagedKVCache, payload: list, slot: int) -> PagedKVCache:
    """Inverse of `extract_slot` through the slot's NEW table row: the pages
    onto the physical pages the allocator re-granted (logical pages past
    the grant land in the sink), the metadata rows rewritten.  Bitwise: the
    slot gets back exactly the bytes `extract_slot` took."""
    segments = _segments(cache)
    for (pool, table), logical in zip(segments, payload):
        if table.shape[1]:
            pool[table[slot].long()] = logical.to(pool.dtype)
    rows = iter(payload[len(segments):])
    src = kvc.tree_map(lambda _: next(rows), _meta_only(cache))
    meta = kvc.tree_update_rows(_meta_only(cache), src, slot)
    return _with_payload_of(meta, cache)


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------

# decode attentions whose output came from the gather path (a dense view of
# every page, then `kvcache.attend_decode`) instead of the page walk
GATHER_DECODES = build.Counter()


@dataclasses.dataclass(frozen=True)
class PagedKVBackend:
    """The paged layout behind the backend interface; stateless.

    `paged_kernel` routes decode attention through the page walk of
    `kernels.paged_qattn` (no dense gather per step) wherever
    `kernel_supported` says the policy's quantization schemes allow it;
    `use_kernels` picks the CUDA kernels (cst_quant, paged_qattn) over their
    plain versions.  Probe steps take their slot weights from the exact
    gather path, as the reference does, so the saliency state stays
    bitwise that of the mixed layout.  `allocator`: "static" or "freelist"
    (pools of `pool_fraction` x the static worst case, see core/alloc.py).
    """

    ccfg: CompressionConfig
    page_size: int = DEFAULT_PAGE_SIZE
    paged_kernel: bool = False
    allocator: str = "static"
    pool_fraction: float = 1.0
    use_kernels: bool = True

    def init_cache(self, b, h_kv, d, max_len, dtype=torch.bfloat16, d_v=None, device=None):
        mx = kvc.init_cache(self.ccfg, b, h_kv, d, max_len, dtype, d_v=d_v, device=device)
        if self.allocator != "freelist":
            return from_mixed(mx, self.page_size)
        pools = tuple(freelist_pool_pages(b, n_pages(cap, self.page_size), self.pool_fraction)
                      for cap in (mx.hi.capacity, mx.lo.capacity, mx.window))
        return from_mixed_freelist(mx, self.page_size, pools)

    def compress_prefill(self, k, v, token_saliency, max_len, probe_nnz=None,
                         dtype=torch.bfloat16, eff=None):
        """Always the static layout: a prefill slice only lives until it is
        inserted into the decode cache."""
        mx = kvc.compress_prefill(self.ccfg, k, v, token_saliency, max_len, probe_nnz=probe_nnz,
                                  dtype=dtype, use_kernel=self.use_kernels, eff=eff)
        return from_mixed(mx, self.page_size)

    def append(self, cache, k_t, v_t, active=None):
        return append_token(cache, k_t, v_t, active=active)

    def attend(self, q, cache, is_probe=False, impl: str = "ref") -> kvc.DecodeAttnOut:
        """The page walk where `kernel_supported` allows it, its slot
        weights on a probe step from the gather path; else the gather path.
        `impl` ("ref" or "int8_algebra") is the gather path's algebra, the
        probe step's recompute included."""
        if self.paged_kernel:
            from repro_torch.kernels.paged_qattn import ops as pq_ops
            if pq_ops.kernel_supported(cache):
                out = pq_ops.attend_paged(q, cache, use_ref=not self.use_kernels,
                                          want_weights=False).out
                w = (kvc.attend_decode(q, cache.dense_view(), impl=impl).slot_weights
                     if kvc.any_probe(is_probe) else None)
                return kvc.DecodeAttnOut(out, w)
        GATHER_DECODES.launches += 1
        return kvc.attend_decode(q, cache.dense_view(), impl=impl)

    def update_probe(self, cache, slot_weights, is_probe):
        return kvc.update_probe_state(cache, slot_weights, is_probe)

    def recompress(self, cache, rows=None, eff=None):
        return recompress(self.ccfg, cache, rows=rows, use_kernel=self.use_kernels, eff=eff)

    def recompress_slot(self, cache, slot: int, eff=None):
        return recompress_slot(self.ccfg, cache, slot, use_kernel=self.use_kernels, eff=eff)

    def insert(self, cache, slice_cache, slot: int):
        return insert_slot(cache, slice_cache, slot)

    def free(self, cache, slot: int):
        return free_slot(cache, slot)

    def dense(self, cache) -> kvc.MixedKVCache:
        """A gathered mixed-layout view of every page, for consumers that read
        the stores directly (MLA's absorbed decode); device gathers only, so
        a captured step may hold it."""
        return cache.dense_view()

    def nbytes(self, cache) -> Tuple[int, int]:
        """(packed, overhead): live payload pages + quantization params, and
        everything else (metadata, tables, free-pool pages)."""
        packed = cache.nbytes_packed()
        return packed, cache.nbytes_total() - packed
