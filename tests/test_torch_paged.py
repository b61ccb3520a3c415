"""The paged layout (`core/paged.py`): parity with the JAX package, and
conformance of the port's layouts with one another.

Against JAX, one op sequence on the same inputs (init, admission inserts
through allocator tables with shuffled page ids, masked appends, probe
updates, a per-slot fold, a rows-masked fold, a free): tables, pools (bar
the free-list sink, which only ever holds don't-care bytes), positions,
codes and quantization parameters equal exactly, and so do the byte counts.

Inside the port, bitwise, as tests/test_backend_conformance.py holds the
reference: (a) mixed and paged-gather decode attention agree bit for bit
after an append, a probe update and a recompression, and the page-walk
backend keeps the same saliency state (its output within 1e-5: the flash
merge sums in another order); (b) insert -> attend -> free -> re-insert
equals a fresh prefill; (d) packed + overhead == the bytes of every leaf.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alloc as jalloc
from repro.core import backend as jbackend
from repro.core import paged as jpaged
from repro.core.policy import CompressionConfig as JCompression
from repro_torch.core import backend as backend_lib
from repro_torch.core import kvcache as kvc
from repro_torch.core import paged
from repro_torch.core.policy import CompressionConfig
from tests.torch_parity import to_np, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
B, HK, D, MAX_LEN, PAGE = 3, 2, 16, 60, 8


def _cfgs(policy="zipcache"):
    return (dataclasses.replace(JCompression.preset(policy), fp_window=8, recompress_interval=8),
            dataclasses.replace(CompressionConfig.preset(policy), fp_window=8,
                                recompress_interval=8))


def _eq(a, b, msg):
    np.testing.assert_array_equal(to_np(a), to_np(b), err_msg=msg)


def _assert_paged_equal(got: paged.PagedKVCache, want):
    """Tables, pools (without the sink page) and metadata, exactly."""
    for name in ("hi", "lo"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.null_page == w.null_page
        _eq(g.table, w.table, f"{name}.table")
        n = g.k_pages.shape[0] if g.null_page is None else g.null_page
        _eq(g.k_pages[:n], w.k_pages[:n], f"{name}.k_pages")
        _eq(g.v_pages[:n], w.v_pages[:n], f"{name}.v_pages")
        for f in ("pos", "acc", "nnz"):
            _eq(getattr(g, f), getattr(w, f), f"{name}.{f}")
        for q in ("k_meta", "v_meta"):
            gq, wq = getattr(g, q), getattr(w, q)
            assert gq.bits == wq.bits and gq.shape == tuple(wq.shape)
            for f in ("scale", "zero", "channel_scale"):
                a, b = getattr(gq, f), getattr(wq, f)
                assert (a is None) == (b is None), f"{name}.{q}.{f}"
                if a is not None:
                    _eq(a, b, f"{name}.{q}.{f}")
    assert got.win_null_page == want.win_null_page
    n = got.win_k_pages.shape[0] if got.win_null_page is None else got.win_null_page
    _eq(got.win_k_pages[:n], want.win_k_pages[:n], "win_k_pages")
    _eq(got.win_v_pages[:n], want.win_v_pages[:n], "win_v_pages")
    for f in ("win_table", "win_pos", "win_acc", "win_nnz", "length", "win_fill"):
        _eq(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("allocator,fraction", [("static", 1.0), ("freelist", 0.7)])
def test_layout_ops_match_jax(allocator, fraction, dtype, rng):
    jc, tc = _cfgs()
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    jbe = jbackend.of(jc, kind="paged", page_size=PAGE, page_allocator=allocator,
                      pool_fraction=fraction)
    tbe = backend_lib.of(tc, kind="paged", page_size=PAGE, page_allocator=allocator,
                         pool_fraction=fraction)
    jcache = jbe.init_cache(B, HK, D, MAX_LEN, dtype)
    tcache = tbe.init_cache(B, HK, D, MAX_LEN, tdt, device="cpu")
    _assert_paged_equal(tcache, jcache)
    alloc = None
    if allocator == "freelist":
        alloc = jalloc.FreeListAllocator.from_caches(jcache, PAGE)
        for seg in alloc.segs.values():
            rng.shuffle(seg.free)

    def sync(jc_, tc_):
        if alloc is None:
            return jc_, tc_
        t = alloc.tables()
        return (jpaged.with_tables(jc_, t["hi"], t["lo"], t["win"]),
                paged.with_tables(tc_, *(torch.from_numpy(t[k]) for k in ("hi", "lo", "win"))))

    for slot, n in ((0, 40), (2, 25)):
        k, v = (rng.normal(size=(1, HK, n, D)).astype(np.float32) for _ in range(2))
        s = rng.uniform(size=(1, n)).astype(np.float32)
        js = jbe.compress_prefill(jnp.asarray(k), jnp.asarray(v), jnp.asarray(s), MAX_LEN,
                                  dtype=dtype)
        ts = tbe.compress_prefill(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(s),
                                  MAX_LEN, dtype=tdt)
        _assert_paged_equal(ts, js)
        if alloc is not None:
            alloc.admit(slot, jalloc.slice_occupancy(js), n + 12, n)
        jcache, tcache = sync(jcache, tcache)
        jcache = jbe.insert(jcache, js, jnp.asarray(slot, jnp.int32))
        tcache = tbe.insert(tcache, ts, slot)
        _assert_paged_equal(tcache, jcache)

    active = np.asarray([True, False, True])
    for step in range(10):
        if alloc is not None:
            for slot in (0, 2):
                alloc.note_append(slot)
        jcache, tcache = sync(jcache, tcache)
        kt = rng.normal(size=(B, HK, D)).astype(np.float32)
        jcache = jbe.append(jcache, jnp.asarray(kt), jnp.asarray(-kt), active=jnp.asarray(active))
        tcache = tbe.append(tcache, torch.from_numpy(kt), torch.from_numpy(-kt),
                            active=torch.from_numpy(active))
        if step % 4 == 3:   # a probe row on slot 0 only, same weights both sides
            w = rng.uniform(size=(B, tcache.capacity)).astype(np.float32)
            probe = np.asarray([True, False, False])
            jcache = jbe.update_probe(jcache, jnp.asarray(w), jnp.asarray(probe))
            tcache = tbe.update_probe(tcache, torch.from_numpy(w), torch.from_numpy(probe))
        _assert_paged_equal(tcache, jcache)

    for slot, per_slot in ((0, True), (2, False)):
        if alloc is not None:
            alloc.fold_grant(slot)
        jcache, tcache = sync(jcache, tcache)
        if per_slot:
            jcache = jbe.recompress_slot(jcache, jnp.asarray(slot, jnp.int32))
            tcache = tbe.recompress_slot(tcache, slot)
        else:
            rows = np.arange(B) == slot
            jcache = jbe.recompress(jcache, rows=jnp.asarray(rows))
            tcache = tbe.recompress(tcache, rows=torch.from_numpy(rows))
        if alloc is not None:
            alloc.fold_shrink(slot)
        jcache, tcache = sync(jcache, tcache)
        _assert_paged_equal(tcache, jcache)

    assert tcache.nbytes_packed() == jcache.nbytes_packed()
    assert tcache.nbytes_total() == jcache.nbytes_total()
    assert tcache.nbytes_free_pool() == jcache.nbytes_free_pool()
    if alloc is not None:
        alloc.free(2)
    jcache, tcache = sync(jcache, tcache)
    jcache = jbe.free(jcache, jnp.asarray(2, jnp.int32))
    tcache = tbe.free(tcache, 2)
    _assert_paged_equal(tcache, jcache)
    assert backend_lib.cache_bytes([tcache]) == jbackend.cache_bytes([jcache])


def _backend(kind, ccfg, **kw):
    return backend_lib.of(ccfg, kind="paged" if kind != "mixed" else "mixed", page_size=8,
                          paged_kernel=kind == "paged-kernel", **kw)


def _kv(rng, b=2, hk=2, l=48, d=16):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    return f(b, hk, l, d), f(b, hk, l, d), torch.from_numpy(rng.uniform(size=(b, l)).astype(
        np.float32))


@pytest.mark.parametrize("policy", ["zipcache", "mikv", "kivi", "gear", "fp16", "h2o"])
def test_attend_bitwise_across_layouts(policy, rng):
    """(a): append, attend, a probe update and a recompression on each layout,
    then the exact (probe-step) attention: mixed and paged-gather agree bit
    for bit, the page-walk backend keeps the same saliency state and slot
    weights and agrees to 1e-5 (mikv's tokenwise V, gear's and kivi's
    stores are not the page walk's layout, so there it takes the gather
    path; fp16 and h2o walk their raw pages)."""
    _, ccfg = _cfgs(policy)
    k, v, s = _kv(rng)
    q = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(np.float32))
    kt = torch.from_numpy(rng.normal(size=(2, 2, 16)).astype(np.float32))
    outs, weights, state = {}, {}, {}
    for kind in ("mixed", "paged", "paged-kernel"):
        be = _backend(kind, ccfg)
        cache = be.compress_prefill(k, v, s if ccfg.uses_saliency else None, 64,
                                    dtype=torch.float32)
        cache = be.append(cache, kt, kt * 0.5)
        dec = be.attend(q, cache, is_probe=True)
        cache = be.update_probe(cache, dec.slot_weights, True)
        cache = be.recompress(cache)
        dec = be.attend(q, cache, is_probe=True)
        outs[kind], weights[kind] = dec.out, dec.slot_weights
        dense = cache if kind == "mixed" else cache.dense_view()
        state[kind] = torch.cat([dense.hi.acc, dense.lo.acc, dense.hi.nnz, dense.lo.nnz,
                                 dense.hi.pos.float(), dense.lo.pos.float()], dim=1)
    assert torch.equal(outs["mixed"], outs["paged"])
    assert torch.equal(weights["mixed"], weights["paged"])
    assert torch.equal(weights["paged"], weights["paged-kernel"])
    assert torch.equal(state["mixed"], state["paged"])
    assert torch.equal(state["paged"], state["paged-kernel"])
    np.testing.assert_allclose(to_np(outs["paged-kernel"]), to_np(outs["paged"]), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["mixed", "paged", "paged-kernel"])
def test_insert_free_reinsert_matches_fresh_prefill(kind, rng):
    """(b): slot churn leaves no residue."""
    _, ccfg = _cfgs()
    k, v, s = _kv(rng)
    be = _backend(kind, ccfg)
    q = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(np.float32))
    ref = be.attend(q, be.compress_prefill(k, v, s, 64, dtype=torch.float32)).out
    slices = [be.compress_prefill(k[i:i + 1], v[i:i + 1], s[i:i + 1], 64, dtype=torch.float32)
              for i in range(2)]
    cache = be.init_cache(2, 2, 16, 64, torch.float32)
    for i in range(2):
        cache = be.insert(cache, slices[i], i)
    assert torch.equal(be.attend(q, cache).out, ref)
    cache = be.free(cache, 1)
    solo = be.compress_prefill(k[:1], v[:1], s[:1], 64, dtype=torch.float32)
    assert torch.equal(be.attend(q, cache).out[0], be.attend(q[:1], solo).out[0])
    cache = be.insert(cache, slices[1], 1)
    assert torch.equal(be.attend(q, cache).out, ref)


@pytest.mark.parametrize("kind,allocator", [("mixed", "static"), ("paged", "static"),
                                            ("paged", "freelist")])
def test_byte_accounting_sums_leaves(kind, allocator, rng):
    """(d): packed + overhead == the bytes of every leaf; a free-list cache
    with nothing granted holds no payload, only free-pool pages."""
    _, ccfg = _cfgs()
    be = _backend(kind, ccfg, page_allocator=allocator, pool_fraction=0.5)
    cache = be.init_cache(3, 2, 16, 64, torch.bfloat16)
    packed, overhead = be.nbytes(cache)
    leaves = sum(t.numel() * t.element_size() for t in kvc.tree_leaves(cache))
    assert packed + overhead == leaves
    got = backend_lib.cache_bytes({"prefix": [], "groups": [{"sub0": cache}] * 2})
    assert got["packed_bytes"] == 2 * packed and got["total_bytes"] == 2 * leaves
    if allocator == "freelist":
        assert got["free_pool_bytes"] == 2 * cache.nbytes_free_pool() > 0
        page_bytes = sum(p.numel() * p.element_size()
                         for p in (cache.hi.k_pages, cache.hi.v_pages, cache.lo.k_pages,
                                   cache.lo.v_pages, cache.win_k_pages, cache.win_v_pages))
        assert cache.nbytes_free_pool() == page_bytes
