"""Port parity for paged decode attention (`kernels/paged_qattn`) against the
JAX package: the plain page walk `ref.paged_segment_ref` against JAX's
`ref.paged_segment_ref` and the Pallas kernel in interpret mode, over
shuffled free-list tables with NULL (sink) entries; `ops.attend_paged`
against JAX's `attend_paged(use_ref=True)` on caches built by the same op
sequence; the `kernel_supported` verdicts per policy; probe-step slot weights taken
bitwise from the gather path; and the layer-level plain version
`ref.paged_layer_ref` (the one-launch-per-layer kernel's function) against
the per-segment path plus `merge_segments_weights`, unpadded against padded
operands.

Tolerance 1e-5 on acc / m / l and on the rescaled slot probabilities
p * exp(m_run - m) (float32 sums in another order), as
tests/test_paged_qattn.py holds the Pallas kernel to its oracle; 1e-6 on
head-pooled slot weights.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core.policy import CompressionConfig as JCompression
from repro.kernels.paged_qattn import kernel as jpq_kernel
from repro.kernels.paged_qattn import ops as jpq_ops
from repro.kernels.paged_qattn import ref as jpq_ref
from repro_torch.core import alloc as alloc_lib
from repro_torch.core import backend as backend_lib
from repro_torch.core import kvcache as kvc
from repro_torch.core import paged
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels.paged_qattn import kernel as pq_kernel
from repro_torch.kernels.paged_qattn import ops as pq_ops
from repro_torch.kernels.paged_qattn import ref as pq_ref
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
TOL = 1e-5


def _segment(rng, bits, h, hk, dtype, b=3, npp=4, page=8, d=16):
    """Kernel operands of one segment: pools behind a shuffled free-list table
    (P = b * npp pages plus a sink), the last page of row 0 and every page of
    row 1 NULL and invalid, a few other holes."""
    n_pool = b * npp
    perm = rng.permutation(n_pool).astype(np.int32).reshape(b, npp)
    table = perm.copy()
    table[0, -1] = n_pool
    table[1, :] = n_pool
    s_pad = npp * page
    pos = np.arange(s_pad, dtype=np.int32)[None].repeat(b, 0)
    pos[rng.uniform(size=pos.shape) < 0.2] = -1
    pos[0, (npp - 1) * page:] = -1
    pos[1] = -1
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    if bits >= 16:
        pages = [f(n_pool + 1, hk, page, d) for _ in range(2)]
        ones, zeros = np.ones((b, hk, 1, d), np.float32), np.zeros((b, hk, 1, d), np.float32)
        params = (ones, zeros, ones, np.ones((b, hk, s_pad, 1), np.float32),
                  np.zeros((b, hk, s_pad, 1), np.float32))
        store = np.float32
    else:
        pages = [rng.integers(-128, 128, size=(n_pool + 1, hk, page, d * bits // 8)).astype(np.int8)
                 for _ in range(2)]
        params = (np.abs(f(b, hk, 1, d)) * 0.3 + 0.05, rng.integers(0, 2 ** bits, (b, hk, 1, d)),
                  np.abs(f(b, hk, 1, d)) + 0.5, np.abs(f(b, hk, s_pad, 1)) * 0.3 + 0.05,
                  rng.integers(0, 2 ** bits, (b, hk, s_pad, 1)))
        store = dtype
    params = [jnp.asarray(np.asarray(p, np.float32)).astype(store) for p in params]
    q = jnp.asarray(f(b, h, d))
    args = (q, jnp.asarray(pages[0]), params[0], params[1], jnp.asarray(pages[1]), *params[2:],
            jnp.asarray(pos), jnp.asarray(table))
    kw = dict(k_bits=bits, v_bits=bits, scale=0.25, k_dtype=store, v_dtype=store)
    return args, kw


def _to_port(args, kw):
    targs = tuple(to_torch(a) for a in args)
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    return targs, dict(kw, k_dtype=dt[kw["k_dtype"]], v_dtype=dt[kw["v_dtype"]])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", [(7, 1), (14, 2), (3, 1), (15, 5)],
                         ids=["h7-hk1", "h14-hk2", "h3-hk1", "h15-hk5"])
@pytest.mark.parametrize("bits", [4, 16])
def test_paged_segment_at_new_group_sizes(bits, heads, dtype, rng):
    """The page walk's plain version at the walk's G = 7 and G = 3 against
    JAX's oracle and the Pallas kernel in interpret mode (the tolerance of
    the g = 2 and g = 1 cases below)."""
    h, hk = heads
    _hold_segment(rng, bits, h, hk, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("bits", [2, 4, 16])
def test_paged_segment_matches_jax_ref_and_kernel(bits, heads, dtype, rng):
    h, hk = heads
    _hold_segment(rng, bits, h, hk, dtype)


def _hold_segment(rng, bits, h, hk, dtype):
    """The plain page walk and the port's wrapper (its plain version on the
    CPU) against JAX's oracle and the Pallas kernel in interpret mode."""
    args, kw = _segment(rng, bits, h, hk, dtype)
    want_ref = jpq_ref.paged_segment_ref(*args, **kw)
    acc, m, l, p, mrun = jpq_kernel.qattn_paged_segment(*args, interpret=True, **kw)
    want_ker = (acc, m, l, p * jnp.exp(mrun - m[..., None]))
    targs, tkw = _to_port(args, kw)
    got_ref = pq_ref.paged_segment_ref(*targs, **tkw)
    gacc, gm, gl, gp, gmrun = pq_kernel.qattn_paged_segment(*targs, **tkw)
    got_wrapper = (gacc, gm, gl, gp * torch.exp(gmrun - gm[..., None]))
    assert tuple(gacc.shape) == (3, h, 16)
    for want in (want_ref, want_ker):
        for got in (got_ref, got_wrapper):
            for name, a, w in zip(("acc", "m", "l", "p"), got, want):
                np.testing.assert_allclose(to_np(a), to_np(w), atol=TOL, rtol=TOL, err_msg=name)
    assert not to_np(got_ref[0])[1].any() and not to_np(got_ref[2])[1].any()  # empty row


def _ccfgs(policy="zipcache", **kw):
    return (dataclasses.replace(JCompression.preset(policy, **kw), fp_window=8,
                                recompress_interval=8),
            dataclasses.replace(CompressionConfig.preset(policy, **kw), fp_window=8,
                                recompress_interval=8))


def _ragged_caches(rng, lengths, hk, d, max_len, page, policy="zipcache", dtype=jnp.float32,
                   n_append=2):
    """The same engine-style ragged batch in both frameworks: per-row batch-1
    prefills inserted into an empty static paged cache (length 0 leaves the
    slot empty), then appends into the staging windows."""
    jc, tc = _ccfgs(policy, saliency_ratio=0.4)
    jbe = jbackend.of(jc, kind="paged", page_size=page)
    tbe = backend_lib.of(tc, kind="paged", page_size=page, paged_kernel=True)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    b = len(lengths)
    jcache = jbe.init_cache(b, hk, d, max_len, dtype)
    tcache = tbe.init_cache(b, hk, d, max_len, tdt, device="cpu")
    for i, n in enumerate(lengths):
        if n == 0:
            continue
        k, v = (rng.normal(size=(1, hk, n, d)).astype(np.float32) for _ in range(2))
        s = rng.uniform(size=(1, n)).astype(np.float32)
        jcache = jbe.insert(jcache, jbe.compress_prefill(jnp.asarray(k), jnp.asarray(v),
                                                         jnp.asarray(s), max_len, dtype=dtype),
                            jnp.asarray(i, jnp.int32))
        tcache = tbe.insert(tcache, tbe.compress_prefill(torch.from_numpy(k), torch.from_numpy(v),
                                                         torch.from_numpy(s), max_len, dtype=tdt),
                            i)
    active = np.asarray([n > 0 for n in lengths])
    for _ in range(n_append):
        kt = rng.normal(size=(b, hk, d)).astype(np.float32)
        jcache = jbe.append(jcache, jnp.asarray(kt), jnp.asarray(kt * 0.5),
                            active=jnp.asarray(active))
        tcache = tbe.append(tcache, torch.from_numpy(kt), torch.from_numpy(kt * 0.5),
                            active=torch.from_numpy(active))
    return jcache, tcache, tbe


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_attend_paged_matches_jax(page, heads, rng):
    h, hk = heads
    lengths = [48, 0, 17, 33]
    jcache, tcache, _ = _ragged_caches(rng, lengths, hk, 16, 60, page)
    q = rng.normal(size=(len(lengths), h, 16)).astype(np.float32)
    want = jpq_ops.attend_paged(jnp.asarray(q), jcache, use_ref=True)
    got = pq_ops.attend_paged(torch.from_numpy(q), tcache)
    np.testing.assert_allclose(to_np(got.out), to_np(want.out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(to_np(got.slot_weights), to_np(want.slot_weights), atol=1e-6)
    assert not to_np(got.out)[1].any() and not to_np(got.slot_weights)[1].any()
    assert pq_ops.attend_paged(torch.from_numpy(q), tcache, want_weights=False).slot_weights \
        is None


def _quant_store(cfg, k, v, bits):
    b, _, n, _ = k.shape
    pos = torch.arange(n, dtype=torch.int32).expand(b, n)
    return kvc.build_store(k, v, pos, torch.zeros(b, n), torch.zeros(b, n), bits, cfg)


@pytest.mark.parametrize("policy,verdict", [("zipcache", True), ("mikv", False), ("fp16", True),
                                            ("kivi", False), ("gear", False)])
def test_kernel_supported_verdicts(policy, verdict, rng):
    """Which policies the page walk serves, decided from the stores' static
    quantization schemes alone; the JAX verdict on a cache JAX built, the
    port's on a store pair quantized per the same policy."""
    jc, tc = _ccfgs(policy)
    k, v = (rng.normal(size=(2, 2, 48, 16)).astype(np.float32) for _ in range(2))
    s = jnp.asarray(rng.uniform(size=(2, 48)).astype(np.float32))
    jcache = jbackend.of(jc, kind="paged", page_size=8).compress_prefill(
        jnp.asarray(k), jnp.asarray(v), s if jc.uses_saliency else None, 64, dtype=jnp.float32)
    assert jpq_ops.kernel_supported(jcache) is verdict
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    stores = [_quant_store(tc, tk, tv, bits) for bits in (tc.high_bits, tc.low_bits)]
    window = {f: t[:, :, :8] if t.dim() == 4 else t[:, :8]
              for f, t in dict(k_win=tk, v_win=tv, win_pos=stores[0].pos,
                               win_acc=stores[0].acc, win_nnz=stores[0].nnz).items()}
    mx = kvc.MixedKVCache(hi=stores[0], lo=stores[1], length=torch.full((2,), 48),
                          win_fill=torch.zeros(2, dtype=torch.int32), **window)
    assert pq_ops.kernel_supported(paged.from_mixed(mx, 8)) is verdict


def test_probe_step_weights_bitwise_gather_path(rng):
    """On a step where some row probes, the kernel backend's slot weights are
    the gather path's bit for bit (the saliency top-k at the next fold would
    drift otherwise); its output agrees to float tolerance.  A step where no
    row probes returns no weights.  Against JAX's gather path: within 1e-6
    (the einsums sum in another order)."""
    jcache, cache, be = _ragged_caches(rng, [40, 25], 2, 16, 56, 8, dtype=jnp.bfloat16)
    gather = backend_lib.of(be.ccfg, kind="paged", page_size=8)
    q = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(np.float32))
    probe = torch.tensor([True, False])
    dec, ref = be.attend(q, cache, is_probe=probe), gather.attend(q, cache)
    assert torch.equal(dec.slot_weights, ref.slot_weights)
    np.testing.assert_allclose(to_np(dec.out), to_np(ref.out), atol=TOL, rtol=TOL)
    assert be.attend(q, cache, is_probe=False).slot_weights is None
    jw = jbackend.of(_ccfgs()[0], kind="paged", page_size=8).attend(jnp.asarray(q.numpy()),
                                                                      jcache).slot_weights
    np.testing.assert_allclose(to_np(dec.slot_weights), to_np(jw), atol=1e-6)


def _freelist_cache(rng, lengths, dtype=torch.float32, page=8, hk=2, d=16, max_len=60,
                    n_append=3):
    """A torch-only free-list paged cache as the engine builds it: shuffled
    free lists, ragged batch-1 prefills per slot (0 leaves the slot empty),
    ungranted table entries NULL (the sink), then appends to the windows."""
    _, tc = _ccfgs(saliency_ratio=0.4)
    be = backend_lib.of(tc, kind="paged", page_size=page, paged_kernel=True,
                        page_allocator="freelist", pool_fraction=0.75)
    b = len(lengths)
    cache = be.init_cache(b, hk, d, max_len, dtype, device="cpu")
    alloc = alloc_lib.FreeListAllocator.from_caches(cache, page)
    for seg in alloc.segs.values():
        rng.shuffle(seg.free)

    def sync(c):
        t = {k: torch.from_numpy(v) for k, v in alloc.tables().items()}
        return paged.with_tables(c, t["hi"], t["lo"], t["win"])

    for slot, n in enumerate(lengths):
        if n:
            k, v = (torch.from_numpy(rng.normal(size=(1, hk, n, d)).astype(np.float32))
                    for _ in range(2))
            s = torch.from_numpy(rng.uniform(size=(1, n)).astype(np.float32))
            sl = be.compress_prefill(k, v, s, max_len, dtype=dtype)
            alloc.admit(slot, alloc_lib.slice_occupancy(sl), n + max_len - max(lengths), n)
            cache = be.insert(sync(cache), sl, slot)
    active = torch.tensor([n > 0 for n in lengths])
    for _ in range(n_append):
        for slot, n in enumerate(lengths):
            if n:
                alloc.note_append(slot)
        kt = torch.from_numpy(rng.normal(size=(b, hk, d)).astype(np.float32))
        cache = be.append(sync(cache), kt, kt * 0.5, active=active)
    alloc.check_invariants()
    return cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("page", [8, 16])
def test_layer_ref_matches_segment_path_and_merge(page, dtype, rng):
    """One layer-level plain call (every segment unpadded, masked at s_seg,
    one merge) equals the per-segment plain path on padded operands merged by
    `merge_segments_weights`: output, and the slot weights p / l over the
    concatenated slots; m is the segments' max and l their rescaled sum."""
    cache = _freelist_cache(rng, [40, 0, 17, 33], dtype=dtype, page=page)
    q = torch.from_numpy(rng.normal(size=(4, 4, 16)).astype(np.float32)).to(dtype)
    segs = pq_ops.layer_segments(cache)
    assert [(sg["k_bits"], sg["v_bits"]) for sg in segs] == [(4, 4), (2, 2), (16, 16)]
    assert all(bool((sg["table"] == sg["k_pages"].shape[0] - 1).any()) for sg in segs)
    padded = pq_ops.layer_segments(cache, pad=True)
    stats = [pq_ops._segment_stats_ref(q, sg, 0.25, True) for sg in padded]
    want_out, want_w = pq_ref.merge_segments_weights(stats)
    out, m, l, p = pq_ref.paged_layer_ref(q, segs, scale=0.25)
    assert out.dtype == dtype and p.shape[-1] == sum(sg["s_seg"] for sg in segs)
    np.testing.assert_allclose(to_np(out), to_np(want_out.to(dtype)), atol=TOL, rtol=TOL)
    m_seg = torch.stack([st[1] for st in stats])
    assert torch.equal(m, m_seg.amax(0))
    l_want = sum(st[2] * torch.exp(st[1] - m) for st in stats)
    np.testing.assert_allclose(to_np(l), to_np(l_want), atol=TOL, rtol=TOL)
    w = torch.cat([wi[:, :, :sg["s_seg"]] for wi, sg in zip(want_w, padded)], dim=-1)
    np.testing.assert_allclose(to_np(p / l.clamp_min(1e-30)[..., None]), to_np(w), atol=1e-6)
    assert not to_np(out)[1].any() and not to_np(l)[1].any()  # the empty slot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layer_ref_unpadded_equals_padded(dtype, rng):
    """The walk masked at s_seg (pos and V token parameters of the stores'
    own length) gives the stats of operands padded to npp * page; the padded
    walk's extra slots carry p = 0."""
    cache = _freelist_cache(rng, [37, 21, 0, 50], dtype=dtype, page=16)
    q = torch.from_numpy(rng.normal(size=(4, 4, 16)).astype(np.float32))
    segs, padded = pq_ops.layer_segments(cache), pq_ops.layer_segments(cache, pad=True)
    assert any(sp["pos"].shape[-1] > sg["pos"].shape[-1] for sg, sp in zip(segs, padded))
    got = pq_ref.paged_layer_ref(q, segs, scale=0.25)
    want = pq_ref.paged_layer_ref(q, padded, scale=0.25)
    for a, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(to_np(a), to_np(w), atol=1e-6, rtol=1e-6)
    at = 0
    parts = []
    for sg, sp in zip(segs, padded):
        n, n_pad = sg["pos"].shape[-1], sp["pos"].shape[-1]
        parts.append(want[3][..., at:at + n])
        assert not to_np(want[3][..., at + n:at + n_pad]).any()
        at += n_pad
    np.testing.assert_allclose(to_np(got[3]), to_np(torch.cat(parts, -1)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("want_weights", [True, False], ids=["weights", "no-weights"])
def test_qattn_paged_layer_cpu_and_attend_paths(want_weights, rng):
    """The layer wrapper on CPU tensors is the layer plain version (p
    relative to m_run = m, or no weights at all), and `attend_paged`'s
    kernel route equals its per-segment plain route."""
    cache = _freelist_cache(rng, [44, 9, 0, 30], page=8)
    q = torch.from_numpy(rng.normal(size=(4, 4, 16)).astype(np.float32))
    segs = pq_ops.layer_segments(cache)
    out, m, l, p, m_run = pq_kernel.qattn_paged_layer(q, segs, scale=0.25,
                                                      want_weights=want_weights)
    rout, rm, rl, rp = pq_ref.paged_layer_ref(q, segs, scale=0.25)
    for a, w in ((out, rout), (m, rm), (l, rl)):
        assert torch.equal(a, w)
    if want_weights:
        assert torch.equal(p * torch.exp(m_run - m[..., None]), rp)
    else:
        assert p is None and m_run is None
    got = pq_ops.attend_paged(q, cache, want_weights=want_weights)
    want = pq_ops.attend_paged(q, cache, use_ref=True, want_weights=want_weights)
    np.testing.assert_allclose(to_np(got.out), to_np(want.out), atol=TOL, rtol=TOL)
    if want_weights:
        np.testing.assert_allclose(to_np(got.slot_weights), to_np(want.slot_weights), atol=1e-6)
    else:
        assert got.slot_weights is None and want.slot_weights is None
