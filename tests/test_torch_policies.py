"""Port parity for the baseline policies (KIVI, GEAR, H2O, fp16, beside
ZipCache and MiKV), the Appendix-A algebra, the exact saliency metrics and
the two decode / prefill levers (`attend_decode(impl="int8_algebra")`,
`blocked_attention(compact=True)`), against the JAX package on the same
numpy-seeded inputs.

Integer artifacts (positions, codes, indices) are exact; so are the floats
of the cache operations, which repeat the reference's arithmetic step by
step.  The reference behaviours the port copies are pinned here: KIVI's fold
empties its raw window into lo; H2O's prefill keeps the top `n_salient` by
the probe saliency it is handed, its fold half recent and half heavy
hitters; a baseline's first fold promotes its mixed stores to f32 through
the zero-capacity store's f32 parameters (ROADMAP.md §3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import kvcache as jkvc
from repro.core import quant as jquant
from repro.core import saliency as jsal
from repro.core.policy import CompressionConfig as JCompression
from repro.kernels.paged_qattn import ops as jpq_ops
from repro.models import attention as jattn
from repro_torch.core import alloc as alloc_lib
from repro_torch.core import backend as backend_lib
from repro_torch.core import kvcache as kvc
from repro_torch.core import paged
from repro_torch.core import quant
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels.decode_qattn import ops as dq_ops
from repro_torch.kernels.paged_qattn import ops as pq_ops
from repro_torch.models import attention
from tests.test_torch_kvcache import _assert_cache_equal
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
POLICIES = ["zipcache", "mikv", "kivi", "gear", "h2o", "fp16"]
BASELINES = ["kivi", "gear", "h2o", "fp16"]
B, HK, L, D, MAX_LEN = 2, 2, 40, 16, 60


def _cfgs(policy, **kw):
    return (dataclasses.replace(JCompression.preset(policy, **kw), fp_window=8,
                                recompress_interval=8),
            dataclasses.replace(CompressionConfig.preset(policy, **kw), fp_window=8,
                                recompress_interval=8))


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _assert_same(got: kvc.MixedKVCache, want: jkvc.MixedKVCache):
    """Every leaf equal, and of the reference's dtype."""
    _assert_cache_equal(got, want)
    for name in ("hi", "lo"):
        for q in ("k", "v"):
            gq, wq = getattr(getattr(got, name), q), getattr(getattr(want, name), q)
            for f in ("codes", "scale", "zero", "channel_scale"):
                a, b = getattr(gq, f), getattr(wq, f)
                if a is not None:
                    assert _dtype_name(a) == str(b.dtype), f"{name}.{q}.{f}: {a.dtype} {b.dtype}"


def _prefill(policy, rng, dtype, b=B, l=L, max_len=MAX_LEN):
    jcfg, cfg = _cfgs(policy)
    k = jnp.asarray(rng.normal(size=(b, HK, l, D)).astype(np.float32)).astype(dtype)
    v = jnp.asarray(rng.normal(size=(b, HK, l, D)).astype(np.float32)).astype(dtype)
    s = rng.uniform(size=(b, l)).astype(np.float32)
    s[:, -5:] = 0.0                                     # ties, as unprobed tokens give
    nnz = rng.integers(1, 5, size=(b, l)).astype(np.float32)
    if not cfg.uses_saliency:
        s = nnz = None
    want = jkvc.compress_prefill(jcfg, k, v, None if s is None else jnp.asarray(s), max_len,
                                 probe_nnz=None if nnz is None else jnp.asarray(nnz),
                                 dtype=dtype)
    got = kvc.compress_prefill(cfg, to_torch(k), to_torch(v),
                               None if s is None else torch.from_numpy(s), max_len,
                               probe_nnz=None if nnz is None else torch.from_numpy(nnz),
                               dtype=to_torch(k).dtype)
    return jcfg, cfg, want, got


# ---------------------------------------------------------------------------
# the cache of every policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_capacities_and_init_cache_match_reference(policy):
    jcfg, cfg = _cfgs(policy)
    for max_len in (16, 60, 1152, 2048, 4224):
        assert kvc.capacities(cfg, max_len) == jkvc.capacities(jcfg, max_len)
    jfull, full = (dataclasses.replace(c, fp_window=128, recompress_interval=100)
                   for c in (jcfg, cfg))
    assert kvc.capacities(full, 1152) == jkvc.capacities(jfull, 1152)
    for dtype in (jnp.float32, jnp.bfloat16):
        _assert_same(kvc.init_cache(cfg, B, HK, D, MAX_LEN, to_torch(jnp.zeros(1, dtype)).dtype),
                     jkvc.init_cache(jcfg, B, HK, D, MAX_LEN, dtype))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_cache_lifecycle_matches_reference(policy, dtype, rng):
    """compress_prefill -> 8 appends (probe steps on the reference's own
    slot weights) -> attend -> recompress (all rows, then one row), every
    leaf equal; the prefill's token accounting as tests/test_kvcache.py
    holds the reference's."""
    jcfg, cfg, want, got = _prefill(policy, rng, dtype)
    _assert_same(got, want)
    n_valid = int(got.hi.valid.sum() + got.lo.valid.sum() + (got.win_pos >= 0).sum())
    if policy == "h2o":
        assert int(got.hi.valid.sum()) == cfg.n_salient(L) * B and not got.lo.capacity
    else:
        assert n_valid == L * B
    f = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32)).astype(dtype)  # noqa: E731
    q = f(B, 2 * HK, D)
    for step in range(8):
        kt, vt = f(B, HK, D), f(B, HK, D)
        want = jkvc.append_token(want, kt, vt)
        got = kvc.append_token(got, to_torch(kt), to_torch(vt))
        jd = jkvc.attend_decode(q, want)
        gd = kvc.attend_decode(to_torch(q), got)
        tol = 1e-5 if dtype == jnp.float32 else 2 ** -7
        np.testing.assert_allclose(to_np(gd.out), to_np(jd.out), atol=tol, rtol=tol)
        np.testing.assert_allclose(to_np(gd.slot_weights), np.asarray(jd.slot_weights),
                                   atol=1e-5)
        np.testing.assert_allclose(to_np(gd.slot_weights).sum(-1), 1.0, rtol=1e-4)
        if step in (3, 7):
            want = jkvc.update_probe_state(want, jd.slot_weights, jnp.asarray(True))
            got = kvc.update_probe_state(got, to_torch(jd.slot_weights), True)
        _assert_same(got, want)
    rows = np.array([False, True])
    _assert_same(kvc.recompress(cfg, got, rows=torch.from_numpy(rows)),
                 jkvc.recompress(jcfg, want, rows=jnp.asarray(rows)))
    _assert_same(kvc.recompress(cfg, got), jkvc.recompress(jcfg, want))


def test_kivi_fold_empties_the_raw_window(rng):
    """Reference behaviour: KIVI's prefill keeps the last fp_window tokens raw
    in the window, but its fold moves EVERY token into the low-bit lo store
    (by recency) and empties the window, so right after a fold no token is
    raw (KIVI's paper keeps the last R raw at all times)."""
    jcfg, cfg, want, got = _prefill("kivi", rng, jnp.float32)
    assert int(got.win_fill[0]) == cfg.fp_window
    assert got.win_pos[0].tolist()[:cfg.fp_window] == list(range(L - cfg.fp_window, L))
    got, want = kvc.recompress(cfg, got), jkvc.recompress(jcfg, want)
    _assert_same(got, want)
    assert not got.hi.capacity and int(got.win_fill.sum()) == 0
    assert not bool((got.win_pos >= 0).any())
    assert sorted(got.lo.pos[0][got.lo.valid[0]].tolist()) == list(range(L))


def test_h2o_prefill_and_fold_retention(rng):
    """Reference behaviour: H2O's prefill keeps the top n_salient tokens by
    the saliency it is handed (the engines hand it Eq. 8's normalized
    score of every row), raw, and evicts the rest; its fold keeps the
    s_hi // 2 most recent tokens and then the heavy hitters by accumulated
    mass (acc), raw."""
    jcfg, cfg = _cfgs("h2o")
    k = rng.normal(size=(1, HK, L, D)).astype(np.float32)
    s = rng.uniform(size=(1, L)).astype(np.float32)
    got = kvc.compress_prefill(cfg, torch.from_numpy(k), torch.from_numpy(k),
                               torch.from_numpy(s), MAX_LEN, dtype=torch.float32)
    n = cfg.n_salient(L)
    assert sorted(got.hi.pos[0][:n].tolist()) == sorted(np.argsort(-s[0], kind="stable")[:n])
    assert got.hi.k.bits == 16 and not got.lo.capacity
    for _ in range(6):
        kt = torch.from_numpy(rng.normal(size=(1, HK, D)).astype(np.float32))
        got = kvc.append_token(got, kt, kt)
    w = torch.from_numpy(rng.uniform(size=(1, got.capacity)).astype(np.float32))
    got = kvc.update_probe_state(got, w, True)
    pos = torch.cat([got.hi.pos, got.lo.pos, got.win_pos], 1)[0]
    acc = torch.cat([got.hi.acc, got.lo.acc, got.win_acc], 1)[0]
    valid = pos >= 0
    n_recent = got.hi.capacity // 2
    recent = set(pos[valid].sort(descending=True).values[:n_recent].tolist())
    rest = [(a, p) for a, p in zip(acc[valid].tolist(), pos[valid].tolist()) if p not in recent]
    heavy = {p for _, p in sorted(rest, key=lambda t: -t[0])[:got.hi.capacity - n_recent]}
    folded = kvc.recompress(cfg, got)
    assert set(folded.hi.pos[0][folded.hi.valid[0]].tolist()) == recent | heavy


@pytest.mark.parametrize("policy", BASELINES)
def test_baseline_fold_promotes_mixed_stores_to_f32(policy, rng):
    """Reference behaviour: the zero-capacity store of a baseline carries f32
    parameters (`_empty_quant`), so the fold's concatenation of the dequantized
    segments is f32 and the rebuilt stores (kivi / gear lo parameters, fp16 /
    h2o raw hi values) come out f32 from a bf16 prefill, here as there."""
    jcfg, cfg, want, got = _prefill(policy, rng, jnp.bfloat16)
    store = "lo" if policy in ("kivi", "gear") else "hi"
    before = getattr(got, store).k
    assert (before.scale if before.bits < 16 else before.codes).dtype == torch.bfloat16
    got, want = kvc.recompress(cfg, got), jkvc.recompress(jcfg, want)
    _assert_same(got, want)
    after = getattr(got, store).k
    assert (after.scale if after.bits < 16 else after.codes).dtype == torch.float32


@pytest.mark.parametrize("policy", POLICIES)
def test_walk_gates_per_store(policy, rng):
    """`decode_qattn` (mixed) and `paged_qattn` (paged) take a layer wherever
    every non-empty store is channelwise K / CST V or raw: zipcache, h2o,
    fp16; the paged verdict equals the JAX package's."""
    jcfg, cfg, want, got = _prefill(policy, rng, jnp.float32)
    verdict = policy in ("zipcache", "h2o", "fp16")
    assert dq_ops.kernel_supported(got) is verdict
    assert pq_ops.kernel_supported(paged.from_mixed(got, 8)) is verdict
    jpaged = jbackend.of(jcfg, kind="paged", page_size=8)
    k = jnp.asarray(rng.normal(size=(B, HK, L, D)).astype(np.float32))
    jc = jpaged.compress_prefill(k, k, jnp.asarray(rng.uniform(size=(B, L)), jnp.float32)
                                 if jcfg.uses_saliency else None, MAX_LEN, dtype=jnp.float32)
    assert jpq_ops.kernel_supported(jc) is verdict


def _drive_layout(kind, cfg, rng_seed):
    """Two slots admitted through `insert` (free list: through the port's
    allocator), 9 masked appends with two probe updates on exact slot
    weights, one slot folded; returns (dense view, the last exact decode)."""
    rng = np.random.default_rng(rng_seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    be = backend_lib.of(cfg, kind="mixed" if kind == "mixed" else "paged", page_size=8,
                        page_allocator="freelist" if kind == "freelist" else "static",
                        pool_fraction=1.0, paged_kernel=kind == "freelist")
    cache = be.init_cache(B, HK, D, MAX_LEN, torch.float32, device="cpu")
    alloc = None
    if kind == "freelist":
        alloc = alloc_lib.FreeListAllocator.from_caches(
            {"prefix": [], "groups": [{"sub0": cache}]}, 8)

    def sync(c):
        if alloc is None:
            return c
        t = alloc.tables()
        return paged.with_tables(c, *(torch.from_numpy(t[n]) for n in ("hi", "lo", "win")))

    for slot, n in ((0, 40), (1, 23)):
        k, v = f(1, HK, n, D), f(1, HK, n, D)
        s = torch.from_numpy(rng.uniform(size=(1, n)).astype(np.float32))
        sl = be.compress_prefill(k, v, s if cfg.uses_saliency else None, MAX_LEN,
                                 dtype=torch.float32)
        if alloc is not None:
            alloc.admit(slot, alloc_lib.slice_occupancy([sl]), n + 12, n)
        cache = be.insert(sync(cache), sl, slot)
    q = f(B, 2 * HK, D)
    for step in range(9):
        if alloc is not None:
            for slot in range(B):
                alloc.note_append(slot)
        cache = be.append(sync(cache), f(B, HK, D), f(B, HK, D))
        dec = be.attend(q, cache, is_probe=True)
        if step in (2, 7):
            cache = be.update_probe(cache, dec.slot_weights, True)
    if alloc is not None:
        alloc.fold_grant(0)
        cache = sync(cache)
    cache = (be.recompress_slot(cache, 0) if kind != "mixed"
             else be.recompress(cache, rows=torch.tensor([True, False])))
    if alloc is not None:
        alloc.fold_shrink(0)
        cache = sync(cache)
        alloc.check_invariants()
    dec = be.attend(q, cache, is_probe=True)
    return (cache if kind == "mixed" else cache.dense_view()), dec


def _assert_torch_cache_equal(a: kvc.MixedKVCache, b: kvc.MixedKVCache):
    for x, y in zip(kvc.tree_leaves(a), kvc.tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("policy", BASELINES)
def test_layouts_bitwise(policy):
    """Mixed, paged static and paged free list (with the page walk where the
    stores allow it, the rest on the gather path) through the same slot
    operations: every valid slot, slot weight and decode output equal bit
    for bit (the walk's output within 1e-5: the flash merge sums in another
    order).  A free-list table pads its unallocated pages with the sink, so
    the views are compared on the valid slots."""
    _, cfg = _cfgs(policy)
    views = {kind: _drive_layout(kind, cfg, 3) for kind in ("mixed", "static", "freelist")}
    (mx, dmx), (st, dst), (fl, dfl) = views["mixed"], views["static"], views["freelist"]
    _assert_torch_cache_equal(mx, st)
    assert torch.equal(dmx.out, dst.out) and torch.equal(dmx.slot_weights, dst.slot_weights)
    assert torch.equal(dst.slot_weights, dfl.slot_weights)
    np.testing.assert_allclose(dfl.out.numpy(), dst.out.numpy(), atol=1e-5, rtol=1e-5)
    k_st, v_st, valid, pos = kvc.cache_keys_values(st)
    k_fl, v_fl, valid_fl, pos_fl = kvc.cache_keys_values(fl)
    assert torch.equal(pos, pos_fl)
    m = valid[:, None, :, None]
    assert torch.equal(k_st * m, k_fl * m) and torch.equal(v_st * m, v_fl * m)


@pytest.mark.parametrize("kind", ["mixed", "paged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_nbytes_partition_matches_reference(kind, policy, rng):
    """packed + overhead == every leaf's bytes, each equal to the JAX
    package's count for the same prefill (tests/test_backend_conformance.py
    (d), over every policy)."""
    jcfg, cfg = _cfgs(policy)
    k = jnp.asarray(rng.normal(size=(B, HK, 48, D)).astype(np.float32)).astype(jnp.bfloat16)
    s = rng.uniform(size=(B, 48)).astype(np.float32)
    jbe = jbackend.of(jcfg, kind=kind, page_size=8)
    tbe = backend_lib.of(cfg, kind=kind, page_size=8)
    jc = jbe.compress_prefill(k, k, jnp.asarray(s) if cfg.uses_saliency else None, 64,
                              dtype=jnp.bfloat16)
    tc = tbe.compress_prefill(to_torch(k), to_torch(k),
                              torch.from_numpy(s) if cfg.uses_saliency else None, 64,
                              dtype=torch.bfloat16)
    packed, overhead = tbe.nbytes(tc)
    assert packed + overhead == sum(t.numel() * t.element_size() for t in kvc.tree_leaves(tc))
    assert (packed, overhead) == tuple(int(x) for x in jbe.nbytes(jc))
    assert backend_lib.cache_bytes(tc) == jbackend.cache_bytes(jc)


# ---------------------------------------------------------------------------
# Appendix-A algebra and the exact saliency metrics
# ---------------------------------------------------------------------------

SHAPES = [(1, 32, 1024, 128), (4, 8, 4096, 128), (2, 4, 37, 16)]


@pytest.mark.parametrize("shape", SHAPES)
def test_appendix_a_algebra_equal_to_the_float(shape):
    b, h, l, d = shape
    for scheme in ("groupwise", "tokenwise", "channelwise_k_tokenwise_v", "zipcache_baseline"):
        for g in (16, 32, 128):
            assert quant.param_count(scheme, b, h, l, d, g) == jquant.param_count(
                scheme, b, h, l, d, g)
        for bits in (2, 3, 4, 8):
            assert quant.compression_ratio(scheme, bits, b, h, l, d) == \
                jquant.compression_ratio(scheme, bits, b, h, l, d)
    for hi, lo, r in ((4, 2, 0.4), (16, 0, 0.4), (4, 4, 1.0), (8, 2, 0.6), (16, 2, 0.0)):
        for kw in ({}, {"fp_window": 128}, {"evict": True}, {"param_scheme": "tokenwise"},
                   {"fp_window": 5000, "param_scheme": "groupwise"}):
            if kw.get("evict") and r == 0.0:   # nothing kept: both divide by zero
                with pytest.raises(ZeroDivisionError):
                    quant.mixed_precision_ratio(hi, lo, r, b, h, l, d, **kw)
                continue
            assert quant.mixed_precision_ratio(hi, lo, r, b, h, l, d, **kw) == \
                jquant.mixed_precision_ratio(hi, lo, r, b, h, l, d, **kw)
    for policy in POLICIES:
        for kw in ({}, {"fp_window": 16}):
            if kw and policy != "kivi":
                continue
            got = CompressionConfig.preset(policy, **kw).compression_ratio(b, h, l, d)
            assert got == JCompression.preset(policy, **kw).compression_ratio(b, h, l, d)
    with pytest.raises(ValueError):
        quant.param_count("rowwise", b, h, l, d)


@pytest.mark.parametrize("scheme", ["channelwise", "tokenwise", "groupwise", "cst"])
def test_fake_quant_matches_reference(scheme, rng):
    x = rng.normal(size=(2, 3, 24, 32)).astype(np.float32)
    kw = {"group_size": 16} if scheme == "groupwise" else {}
    for dtype in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dtype)
        np.testing.assert_array_equal(to_np(quant.fake_quant(to_torch(xj), 2, scheme, **kw)),
                                      to_np(jquant.fake_quant(xj, 2, scheme, **kw)))


def test_exact_saliency_metrics_match_reference(rng):
    """Eq. 7 / Eq. 8 and the probe substitution, within 1e-6."""
    tol = dict(atol=1e-6, rtol=1e-6)
    logits = rng.normal(size=(2, 3, 12, 20)).astype(np.float32)
    causal = np.arange(20)[None, :] <= (np.arange(12)[:, None] + 8)
    a = np.where(causal, np.exp(logits), 0.0).astype(np.float32)
    a /= a.sum(-1, keepdims=True)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    np.testing.assert_allclose(sal.accumulated_scores(ta).numpy(),
                               np.asarray(jsal.accumulated_scores(ja)), **tol)
    for q_len, kv_len in ((12, 20), (20, 20), (1, 7)):
        np.testing.assert_array_equal(sal.causal_nnz(q_len, kv_len, device="cpu").numpy(),
                                      np.asarray(jsal.causal_nnz(q_len, kv_len)))
    np.testing.assert_allclose(sal.normalized_scores(ta).numpy(),
                               np.asarray(jsal.normalized_scores(ja)), **tol)
    nnz = rng.integers(0, 4, size=(20,)).astype(np.float32)
    np.testing.assert_allclose(sal.normalized_scores(ta, torch.from_numpy(nnz)).numpy(),
                               np.asarray(jsal.normalized_scores(ja, jnp.asarray(nnz))), **tol)
    np.testing.assert_allclose(sal.head_mean(sal.normalized_scores(ta)).numpy(),
                               np.asarray(jsal.head_mean(jsal.normalized_scores(ja))), **tol)
    pos = np.array([3, 7, 7, 15, 19], np.int32)
    np.testing.assert_allclose(
        sal.probe_normalized_scores(ta[..., :5, :], torch.from_numpy(pos), 20).numpy(),
        np.asarray(jsal.probe_normalized_scores(ja[..., :5, :], jnp.asarray(pos), 20)), **tol)
    q = rng.normal(size=(2, 4, 20, 16)).astype(np.float32)
    k = rng.normal(size=(2, 4, 20, 16)).astype(np.float32)
    for strategy in ("random+recent", "all"):
        jspec = jsal.select_probes(20, strategy, 0.3, 1)
        spec = sal.select_probes(20, strategy, 0.3, 1)
        for pool in (True, False):
            np.testing.assert_allclose(
                sal.probe_scores_from_qk(torch.from_numpy(q), torch.from_numpy(k), spec,
                                         pool_heads=pool).numpy(),
                np.asarray(jsal.probe_scores_from_qk(jnp.asarray(q), jnp.asarray(k), jspec,
                                                     pool_heads=pool)), **tol)


# ---------------------------------------------------------------------------
# the levers: int8-algebra decode, compact softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(2, 4, 2, 96, 32), (1, 8, 1, 64, 16)])
def test_int8_algebra_decode_matches_reference(dims, rng):
    """tests/test_kernels.py's two shapes and tolerances: the port's int8
    route against the JAX int8 route and against the port's exact route."""
    b, hq, hkv, l, d = dims
    jcfg, cfg = (dataclasses.replace(c.zipcache(saliency_ratio=0.4), fp_window=16,
                                     recompress_interval=16)
                 for c in (JCompression, CompressionConfig))
    k, v = (rng.normal(size=(b, hkv, l, d)).astype(np.float32) for _ in range(2))
    s = rng.uniform(size=(b, l)).astype(np.float32)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    jc = jkvc.compress_prefill(jcfg, jnp.asarray(k), jnp.asarray(v), jnp.asarray(s), l + 16,
                               dtype=jnp.float32)
    tc = kvc.compress_prefill(cfg, torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(s), l + 16, dtype=torch.float32)
    for _ in range(5):
        kt = rng.normal(size=(b, hkv, d)).astype(np.float32)
        jc = jkvc.append_token(jc, jnp.asarray(kt), jnp.asarray(kt))
        tc = kvc.append_token(tc, torch.from_numpy(kt), torch.from_numpy(kt))
    got = kvc.attend_decode(torch.from_numpy(q), tc, impl="int8_algebra")
    for want in (jkvc.attend_decode(jnp.asarray(q), jc, impl="int8_algebra"),
                 kvc.attend_decode(torch.from_numpy(q), tc)):
        np.testing.assert_allclose(to_np(got.out), to_np(want.out), atol=2e-2, rtol=1e-2)
        np.testing.assert_allclose(to_np(got.slot_weights), to_np(want.slot_weights),
                                   atol=1e-3)


@pytest.mark.parametrize("policy", POLICIES)
def test_int8_algebra_takes_zipcache_and_raw_stores_only(policy, rng):
    """zipcache's stores and the raw ones of fp16 / h2o go through the int8
    algebra (raw segments exactly as the exact route); a store in another
    scheme raises a ValueError naming it, and computes nothing else."""
    _, cfg, _, got = _prefill(policy, rng, jnp.float32)
    q = torch.from_numpy(rng.normal(size=(B, 2 * HK, D)).astype(np.float32))
    if policy in ("mikv", "gear", "kivi"):
        # kivi's K groups span the whole head dim here (group 32 > d 16): tokenwise
        bad = "V is tokenwise" if policy in ("mikv", "gear") else "K is tokenwise"
        with pytest.raises(ValueError, match=bad):
            kvc.attend_decode(q, got, impl="int8_algebra")
        return
    alg, ref = kvc.attend_decode(q, got, impl="int8_algebra"), kvc.attend_decode(q, got)
    tol = dict(atol=1e-6, rtol=1e-6) if policy != "zipcache" else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(alg.out.numpy(), ref.out.numpy(), **tol)
    np.testing.assert_allclose(alg.slot_weights.numpy(), ref.slot_weights.numpy(), atol=1e-3)
    be = backend_lib.of(cfg)
    dec = be.attend(q, got, is_probe=True, impl="int8_algebra")
    assert torch.equal(dec.slot_weights, alg.slot_weights)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("q_block", [16, 48])
def test_compact_softmax_matches_reference(q_block, dtype, rng):
    """bf16 logits and probabilities.  Against the JAX compact route: outputs
    and probe column sums within 1e-5 (measured: 1.2e-7 at f32 inputs, 0 at
    bf16).  Against the f32 route: each probability (one probe row, the mean
    over heads) within the reference docstring's 1e-2 (measured: 1.5e-3 at
    f32 inputs, 8.9e-4 at bf16); the outputs differ by what the reference's
    own two routes differ by (measured: 0.0130 at f32 inputs, 0.0078 = one
    bf16 ulp at bf16), held within 1e-5 of that gap and below 2e-2."""
    f = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32)).astype(dtype)  # noqa: E731
    q, k, v = f(2, 4, 48, 16), f(2, 2, 48, 16), f(2, 2, 48, 16)
    tq, tk, tv = to_torch(q), to_torch(k), to_torch(v)
    pos = np.array(jsal.select_probes(48).positions)
    jspec = jsal.ProbeSpec(jnp.asarray(pos), 0, len(pos))
    spec = sal.ProbeSpec(torch.from_numpy(pos), 0, len(pos))
    wo, wc = jattn.blocked_attention(q, k, v, q_block=q_block, probe=jspec, compact=True)
    go, gc = attention.blocked_attention(tq, tk, tv, q_block=q_block, probe=spec, compact=True)
    assert go.dtype == tq.dtype
    np.testing.assert_allclose(to_np(go), to_np(wo), atol=1e-5)
    np.testing.assert_allclose(to_np(gc), to_np(wc), atol=1e-5)
    fo, _ = attention.blocked_attention(tq, tk, tv, q_block=q_block)
    jfo, _ = jattn.blocked_attention(q, k, v, q_block=q_block)
    gap, jgap = np.abs(to_np(go) - to_np(fo)).max(), np.abs(to_np(wo) - to_np(jfo)).max()
    assert abs(gap - jgap) <= 1e-5 and gap < 2e-2, (gap, jgap)
    for row in range(0, 48, 5):
        one = sal.ProbeSpec(torch.tensor([row], dtype=torch.int32), 0, 1)
        _, pc = attention.blocked_attention(tq, tk, tv, q_block=q_block, probe=one, compact=True)
        _, pf = attention.blocked_attention(tq, tk, tv, q_block=q_block, probe=one)
        np.testing.assert_allclose(pc.numpy(), pf.numpy(), atol=1e-2)
