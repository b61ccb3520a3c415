"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips where torch sees no CUDA device (decided in
the fixture, never at import).  On a CUDA host:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
This file imports no JAX, so it runs where only the port is installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import alloc as alloc_lib
from repro_torch.core import backend as backend_lib
from repro_torch.core import kvcache as kvc
from repro_torch.core import paged
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels import build
from repro_torch.kernels.cst_quant import kernel as cst_kernel
from repro_torch.kernels.cst_quant import ref as cst_ref
from repro_torch.kernels.decode_qattn import kernel as dq_kernel
from repro_torch.kernels.decode_qattn import ops as dq_ops
from repro_torch.kernels.decode_qattn import ref as dq_ref
from repro_torch.kernels.paged_qattn import kernel as pq_kernel
from repro_torch.kernels.paged_qattn import ops as pq_ops
from repro_torch.kernels.paged_qattn import ref as pq_ref
from repro_torch.kernels.probe_flash import kernel as pf_kernel
from repro_torch.kernels.probe_flash import ops as pf_ops
from repro_torch.kernels.probe_flash import ref as pf_ref
from repro_torch.launch import steps as steps_lib
from repro_torch.models import attention, blocks, common, registry
from repro_torch.serving import (ContinuousEngine, Request, ServeConfig, ServingEngine,
                                 pack_requests, probe_flag)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    build.build_all()
    return torch.device("cuda")


def _randn(gen, *shape, dtype=torch.float32, dev="cuda", scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 77, 128), (2, 64, 16)])
def test_cst_quant_exact(dev, bits, dtype, shape):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, *shape, dtype=dtype, scale=2.0)
    c = torch.sqrt(x.float().abs().amax(dim=1).double()).float().clamp_min(1e-4)
    got = cst_kernel.cst_quant_rows(x, c, bits)
    want = cst_ref.cst_quant_rows_ref(x, c, bits)
    on_cpu = cst_ref.cst_quant_rows_ref(x.cpu(), c.cpu(), bits)  # the JAX-parity path
    for a, b, w in zip(got, want, on_cpu):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), w)


@pytest.mark.parametrize("split", [None, 1], ids=["cluster", "one-cta"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d", [(4, 461, 128), (1, 691, 128), (4, 691, 64), (1, 37, 64)])
def test_quantize_store_matches_plain(dev, b, s, d, dtype, bits, split):
    """One store through the kernel equals its plain version (on the card
    and on the CPU, the JAX-parity path) bit for bit: codes and parameters
    in the store dtype.  Slots gather shuffled source tokens with a -1 tail;
    with b 4, row 1 is all -1 and kv head 1 of row 2 is all zeros (scales
    clamp to eps); both grid designs (a cluster per slice by default, one
    CTA per slice); a strided source (a transposed view)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    hk, l = 4, s + 50
    k = _randn(gen, b, l, hk, d, dtype=dtype, scale=2.0).transpose(1, 2)
    v = _randn(gen, b, hk, l, d, dtype=dtype)
    n_live = s - s // 5
    idx = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    for row in range(b):
        idx[row, :n_live] = torch.randperm(l, generator=gen, device=dev)[:n_live].int()
    if b == 4:
        idx[1] = -1
        k[2, 1] = 0
        v[2, 1] = 0
    before = cst_kernel.KERNEL.launches
    got = cst_kernel.quantize_store(k, v, idx, bits, split=split)
    assert cst_kernel.KERNEL.launches == before + 1
    want = cst_ref.quantize_store_ref(k, v, idx, bits)
    on_cpu = cst_ref.quantize_store_ref(k.cpu(), v.cpu(), idx.cpu(), bits)
    names = ("k_codes", "k_scale", "k_zero", "v_codes", "v_scale", "v_zero", "v_cscale")
    for name, a, w, c in zip(names, got, want, on_cpu):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, w), name
        assert torch.equal(a.cpu(), c), name


@pytest.mark.parametrize("where", ["decode", "prefill"])
def test_out_proj_copies_no_weight(dev, where):
    """The attention-output projection at yi-6b's width reads `wo` through a
    view: a record_shapes profile on the card shows no copy or clone of a
    tensor with wo's element count, and the product equals the einsum's
    within one bf16 ulp of its largest magnitude."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import common
    gen = torch.Generator(device=dev).manual_seed(8)
    h, d, e = 32, 128, 4096
    wo = _randn(gen, h, d, e, dtype=torch.bfloat16, scale=0.01)
    if where == "decode":
        out = _randn(gen, 4, h, d, dtype=torch.bfloat16)
        want = torch.einsum("bhd,hde->be", out, wo)
        fn = lambda: common.out_proj(out, wo)  # noqa: E731
    else:
        out = _randn(gen, 4, h, 64, d, dtype=torch.bfloat16)
        want = torch.einsum("bhld,hde->ble", out, wo)
        fn = lambda: common.out_proj(out.transpose(1, 2), wo)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        got = fn()
        torch.cuda.synchronize()
    copies = [(ev.name, ev.input_shapes) for ev in prof.events()
              if ev.name in ("aten::copy_", "aten::clone") and ev.input_shapes
              and ev.input_shapes[0] and int(np.prod(ev.input_shapes[0])) == wo.numel()]
    assert not copies, copies
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2 ** -7 * want.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hk,lq,lkv,d", [(2, 4, 2, 48, 48, 16), (1, 8, 2, 100, 100, 128),
                                            (1, 4, 4, 33, 70, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_matches_plain(dev, dtype, b, h, hk, lq, lkv, d, causal):
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (_randn(gen, b, n, l, d, dtype=dtype) for n, l in ((h, lq), (hk, lkv), (hk, lkv)))
    out, lse = pf_kernel.flash_fwd(q, k, v, causal=causal)
    ref_out, ref_lse = pf_ref.flash_fwd_ref(q, k, v, causal=causal)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,hk,lq,lkv,d", [(4, 8, 2, 130, 130, 128), (4, 4, 4, 70, 200, 64),
                                            (1, 32, 4, 1024, 1024, 128), (1, 8, 8, 1, 77, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_tensor_cores_matches_plain(dev, b, h, hk, lq, lkv, d, causal):
    """The bf16 (tensor-core) kernel at ragged lq (not a multiple of 64), a
    diagonal offset (lkv > lq), d 16 / 64 / 128, batch 1 and 4, the
    continuous admission shape; out within one bf16 ulp of 1, LSE 1e-5."""
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (_randn(gen, b, n, l, d, dtype=torch.bfloat16)
               for n, l in ((h, lq), (hk, lkv), (hk, lkv)))
    out, lse = pf_kernel.flash_fwd(q, k, v, causal=causal)
    ref_out, ref_lse = pf_ref.flash_fwd_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2 ** -7, rtol=2 ** -7)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_colsum_matches_plain(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(2)
    b, h, hk, l, d = 2, 8, 2, 1024, 128
    q, k = _randn(gen, b, h, l, d, dtype=dtype), _randn(gen, b, hk, l, d, dtype=dtype)
    _, lse = pf_ref.flash_fwd_ref(q, k, k)
    pos = pf_ops.unique_probe_rows(sal.select_probes(l).positions.to(dev))  # repeats -> -1
    safe = pos.clamp(0, l - 1).long()
    pos_b = pos[None].expand(b, -1).contiguous()
    got = pf_kernel.probe_colsum(q[:, :, safe], lse[:, :, safe], pos_b, k, lq=l)
    want = pf_ref.probe_colsum_ref(q[:, :, safe], lse[:, :, safe], pos_b, k, lq=l)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _probe_rows(rng, b, n_p, lq, kind):
    """(b, n_p) int32 probe positions per batch row: unsorted distinct rows
    with a few pad rows (-1), or every row below position 20."""
    rows = []
    for _ in range(b):
        if kind == "low":
            r = rng.integers(0, 20, size=n_p)
        else:
            r = rng.permutation(lq)[:n_p]
            r[rng.choice(n_p, size=5, replace=False)] = -1
        rows.append(r)
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("hpc", [1, 4])
@pytest.mark.parametrize("rows", ["unsorted", "unsorted-noncausal", "low"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("b", [1, 4])
def test_probe_colsum_tensor_cores_matches_plain(dev, b, d, rows, hpc, monkeypatch):
    """The bf16 (tensor-core) kernel with 1 or 4 query heads per CTA: lq <
    lkv (a diagonal offset), 75 probe rows (not a multiple of 16) in no
    order with pad rows, or every row below the first column of all but the
    first CTA (their tiles skipped: exact zeros there); atol/rtol 1e-4
    against the plain version (f32 sums in another order), and a second
    call bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(8)
    h, hk, lq, lkv, n_p = 8, 2, 300, 333, 75
    # the smallest grid that gives hpc heads per CTA
    monkeypatch.setattr(pf_kernel, "MIN_CTAS", -(-lkv // pf_kernel.COLSUM_COLS) * (h // hpc) * b)
    assert pf_kernel._heads_per_cta(b, h, h // hk, lkv) == hpc
    q, k = _randn(gen, b, h, lq, d, dtype=torch.bfloat16), _randn(gen, b, hk, lkv, d,
                                                                   dtype=torch.bfloat16)
    causal = rows != "unsorted-noncausal"
    _, lse = pf_ref.flash_fwd_ref(q, k, k, causal=causal)
    pos = torch.from_numpy(_probe_rows(np.random.default_rng(b * d), b, n_p, lq,
                                       rows.split("-")[0])).to(dev)
    safe = pos.clamp(0, lq - 1).long()
    qp = torch.stack([q[i][:, safe[i]] for i in range(b)])
    lse_p = torch.stack([lse[i][:, safe[i]] for i in range(b)])
    before = pf_kernel.COLSUM.launches
    got = pf_kernel.probe_colsum(qp, lse_p, pos, k, causal=causal, lq=lq)
    assert pf_kernel.COLSUM.launches == before + 1
    want = pf_ref.probe_colsum_ref(qp, lse_p, pos, k, causal=causal, lq=lq)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, pf_kernel.probe_colsum(qp, lse_p, pos, k, causal=causal, lq=lq))
    if rows == "low":  # row + (lkv - lq) < 20 + 33 < 64: no column from 64 on is reached
        assert not got[:, 64:].any()


def test_probe_colsum_deterministic(dev):
    """At the lockstep shape (yi-6b widths, batch 4, prompt 1024, the probe
    rows of select_probes(1024)), three calls give bitwise-equal sums: they
    decide the saliency ties."""
    gen = torch.Generator(device=dev).manual_seed(9)
    b, h, hk, l, d = 4, 32, 4, 1024, 128
    q, k = _randn(gen, b, h, l, d, dtype=torch.bfloat16), _randn(gen, b, hk, l, d,
                                                                 dtype=torch.bfloat16)
    _, lse = pf_kernel.flash_fwd(q, k, k)
    pos = pf_ops.unique_probe_rows(sal.select_probes(l).positions.to(dev))
    safe = pos.clamp(0, l - 1).long()
    args = (q[:, :, safe].contiguous(), lse[:, :, safe].contiguous(),
            pos[None].expand(b, -1).contiguous(), k)
    first = pf_kernel.probe_colsum(*args, lq=l)
    for _ in range(2):
        assert torch.equal(pf_kernel.probe_colsum(*args, lq=l), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hk,g,d", [(2, 2, 16), (4, 8, 128)])
def test_decode_qattn_matches_plain(dev, dtype, hk, g, d):
    gen = torch.Generator(device=dev).manual_seed(3)
    cfg = CompressionConfig.zipcache()
    b, l = 2, 200
    k, v = _randn(gen, b, hk, l, d, dtype=dtype), _randn(gen, b, hk, l, d, dtype=dtype)
    s = torch.rand((b, l), generator=gen, device=dev)
    cache = kvc.compress_prefill(cfg, k, v, s, 300, dtype=dtype)
    q = _randn(gen, b, hk * g, d, dtype=dtype)
    for store in (cache.hi, cache.lo):
        args = (q, store.k.codes, store.k.scale, store.k.zero, store.v.codes,
                store.v.channel_scale, store.v.scale, store.v.zero, store.pos,
                store.k.bits, store.v.bits)
        acc, m, l_ = dq_kernel.qattn_segment(*args)
        racc, rm, rl = dq_ref.qattn_segment_ref(*args)
        torch.testing.assert_close(m, rm, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(l_, rl, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(acc, racc, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("hi", ["live", "all-empty", "absent"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", [(2, 16), (8, 128)])
def test_mixed_layer_matches_plain(dev, g, d, dtype, hi):
    """One `qattn_mixed_layer` launch over a mixed cache's 4-bit hi, 2-bit lo
    and partly filled raw window against the layer plain version: out
    within 1e-4 (f32) or one bf16 ulp (bf16) of its largest magnitude (>=
    1), f32 sums in another order.  The hi segment also comes with no valid
    slot at all, and not at all."""
    gen = torch.Generator(device=dev).manual_seed(10)
    cfg = CompressionConfig.zipcache()
    b, hk, l = 3, 2, 200
    k, v = _randn(gen, b, hk, l, d, dtype=dtype), _randn(gen, b, hk, l, d, dtype=dtype)
    cache = kvc.compress_prefill(cfg, k, v, torch.rand((b, l), generator=gen, device=dev), 300,
                                 dtype=dtype)
    for _ in range(7):
        cache = kvc.append_token(cache, _randn(gen, b, hk, d, dtype=dtype),
                                 _randn(gen, b, hk, d, dtype=dtype))
    q = _randn(gen, b, hk * g, d, dtype=dtype)
    segs = dq_ops.mixed_segments(cache)
    assert [(o["k_bits"], o["v_bits"]) for o in segs] == [(4, 4), (2, 2), (16, 16)]
    if hi == "all-empty":
        segs[0] = dict(segs[0], pos=torch.full_like(segs[0]["pos"], -1))
    elif hi == "absent":
        segs = segs[1:]
    before = dq_kernel.KERNEL.launches
    out = dq_kernel.qattn_mixed_layer(q, segs)
    assert dq_kernel.KERNEL.launches == before + 1
    want = dq_ref.mixed_layer_ref(q, segs)
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(),
                               atol=tol * max(want.float().abs().max().item(), 1.0), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_layer_shares_of_a_split(dev, dtype):
    """The launches a mesh split makes (`core.sharded`): each half of the kv
    heads with the whole layer's split plan, concatenated, bitwise the
    whole launch (and `plan=b * hk` bitwise no plan); each half of the
    slots with the statistics output, (m, l) within 1e-5 of the plain
    version's and merged in order within one bf16 ulp (1e-4 in f32) of the
    whole launch; acc / l is the normalized output's launch."""
    gen = torch.Generator(device=dev).manual_seed(11)
    cfg = CompressionConfig.zipcache()
    b, hk, g, d, l = 4, 4, 8, 128, 600
    k, v = _randn(gen, b, hk, l, d, dtype=dtype), _randn(gen, b, hk, l, d, dtype=dtype)
    cache = kvc.compress_prefill(cfg, k, v, torch.rand((b, l), generator=gen, device=dev), 700,
                                 dtype=dtype)
    for _ in range(9):
        cache = kvc.append_token(cache, _randn(gen, b, hk, d, dtype=dtype),
                                 _randn(gen, b, hk, d, dtype=dtype))
    q = _randn(gen, b, hk * g, d, dtype=dtype)
    segs = dq_ops.mixed_segments(cache)
    whole = dq_kernel.qattn_mixed_layer(q, segs)
    assert torch.equal(dq_kernel.qattn_mixed_layer(q, segs, plan=b * hk), whole)
    heads = torch.cat([dq_kernel.qattn_mixed_layer(
        q.chunk(2, 1)[i].contiguous(), [dq_ops.segment_share(o, 1, i, 2) for o in segs],
        plan=b * hk) for i in range(2)], dim=1)
    assert torch.equal(heads, whole)
    acc, m, l_ = dq_kernel.qattn_mixed_layer(q, segs, stats=True)
    assert torch.equal((acc / l_.clamp_min(1e-30)[..., None]).to(dtype), whole)
    halves = []
    for i in range(2):
        share = [dq_ops.segment_share(o, 2, i, 2) for o in segs]
        got = dq_kernel.qattn_mixed_layer(q, share, stats=True)
        want = dq_ref.mixed_layer_ref(q, share, stats=True)
        for a, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)
        halves.append(got)
    merged = dq_ref.merge_segments_ref(halves).to(dtype)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(merged.float(), whole.float(),
                               atol=tol * max(whole.float().abs().max().item(), 1.0), rtol=0)


def test_engine_runs_every_kernel(dev):
    """Smoke-width lockstep run on the card: every kernel launches, and the
    prefill logits agree with the plain path's within bf16 noise."""
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    scfg = ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12)
    params = registry.materialize_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": pack_requests([rng.integers(2, cfg.vocab, size=48) for _ in range(2)],
                                     2, 48)}
    kernels = (cst_kernel.KERNEL, pf_kernel.FLASH, pf_kernel.COLSUM, dq_kernel.KERNEL)
    before = [k.launches for k in kernels]
    out = ServingEngine(cfg, ccfg, scfg, params, device=dev).generate(batch)
    assert out["tokens"].shape == (2, 12)
    assert all(k.launches > n for k, n in zip(kernels, before))
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    lk, _ = registry.prefill(params, {"tokens": tokens}, cfg,
                             ServingEngine(cfg, ccfg, scfg, params, device=dev).ctx)
    lp, _ = registry.prefill(params, {"tokens": tokens}, cfg,
                             ServingEngine(cfg, ccfg, scfg, params, device=dev,
                                           use_kernels=False).ctx)
    assert (lk.float() - lp.float()).abs().max() <= 2 ** -6 * lp.float().abs().max()


def _freelist_cache(dev, gen, dtype, page, lengths, hk=2, d=16, max_len=200, n_append=3):
    """A free-list paged cache as the engine builds it: shuffled free lists
    (physical ids in no order), ragged prefills inserted per slot (length 0
    leaves the slot empty: an all-invalid row), ungranted pages NULL (the
    sink), then a few appends into the staging windows."""
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), recompress_interval=16)
    be = backend_lib.of(ccfg, kind="paged", page_size=page, paged_kernel=True,
                        page_allocator="freelist", pool_fraction=0.75)
    b = len(lengths)
    cache = be.init_cache(b, hk, d, max_len, dtype, device=dev)
    alloc = alloc_lib.FreeListAllocator.from_caches(cache, page)
    rng = np.random.default_rng(0)
    for seg in alloc.segs.values():
        rng.shuffle(seg.free)

    def sync(c):
        t = {k: torch.from_numpy(v).to(dev) for k, v in alloc.tables().items()}
        return paged.with_tables(c, t["hi"], t["lo"], t["win"])

    for slot, n in enumerate(lengths):
        if n == 0:
            continue
        k, v = (_randn(gen, 1, hk, n, d, dtype=dtype, dev=dev) for _ in range(2))
        s = torch.rand((1, n), generator=gen, device=dev)
        sl = be.compress_prefill(k, v, s, max_len, dtype=dtype)
        alloc.admit(slot, alloc_lib.slice_occupancy(sl), n + max_len - max(lengths), n)
        cache = be.insert(sync(cache), sl, slot)
    active = torch.tensor([n > 0 for n in lengths], device=dev)
    for _ in range(n_append):
        for slot, n in enumerate(lengths):
            if n:
                alloc.note_append(slot)
        cache = sync(cache)
        kt = _randn(gen, b, hk, d, dtype=dtype, dev=dev)
        cache = be.append(cache, kt, kt * 0.5, active=active)
    alloc.check_invariants()
    return cache


@pytest.mark.parametrize("want_weights", [True, False], ids=["weights", "no-weights"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 64])
def test_paged_qattn_matches_plain(dev, page, dtype, q_dtype, want_weights):
    """Each segment (4-bit hi, 2-bit lo, raw window) through free-list tables
    with shuffled page ids, NULL entries and an all-invalid row: acc, m and l
    of the live rows within 1e-4 of the plain version relative to their
    largest magnitude (f32 sums in another order), the rescaled slot
    weights within 1e-5, zeros on the empty row."""
    gen = torch.Generator(device=dev).manual_seed(4)
    cache = _freelist_cache(dev, gen, dtype, page, lengths=[150, 0, 37, 90])
    q = _randn(gen, 4, 8, 16, dtype=q_dtype, dev=dev)
    scale = 0.25
    segs = pq_ops.layer_segments(cache, pad=True)
    assert [(o["k_bits"], o["v_bits"]) for o in segs] == [(4, 4), (2, 2), (16, 16)]
    assert any((o["table"] == cache.hi.null_page).any() for o in segs[:1])
    for ops in segs:
        args = (q, ops["k_pages"], ops["k_scale"], ops["k_zero"], ops["v_pages"],
                ops["v_cscale"], ops["v_tscale"], ops["v_tzero"], ops["pos"], ops["table"])
        kw = dict(k_bits=ops["k_bits"], v_bits=ops["v_bits"], scale=scale,
                  k_dtype=ops["k_dtype"], v_dtype=ops["v_dtype"])
        acc, m, l, p, m_run = pq_kernel.qattn_paged_segment(*args, want_weights=want_weights,
                                                            **kw)
        racc, rm, rl, rp = pq_ref.paged_segment_ref(*args, **kw)
        live = torch.tensor([True, False, True, True], device=dev)
        for a, w in ((acc, racc), (m, rm), (l, rl)):
            a, w = a[live], w[live]
            torch.testing.assert_close(a, w, atol=1e-4 * max(w.abs().max().item(), 1.0),
                                       rtol=0)
        # the empty row: l = 0, acc = 0, m at the mask value
        assert not l[1].any() and not acc[1].any() and torch.equal(m[1], rm[1])
        if want_weights:
            torch.testing.assert_close(p * torch.exp(m_run - m[..., None]), rp, atol=1e-5,
                                       rtol=1e-5)
        else:
            assert p is None and m_run is None


@pytest.mark.parametrize("want_weights", [True, False], ids=["weights", "no-weights"])
@pytest.mark.parametrize("hi", ["live", "all-empty", "absent"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 64])
def test_paged_layer_matches_plain(dev, page, dtype, hi, want_weights):
    """One `qattn_paged_layer` launch over a layer's segments (4-bit hi,
    2-bit lo, raw window) through free-list tables with shuffled page ids,
    NULL entries and an empty slot, unpadded operands, against the layer
    plain version: out within 1e-4 of its largest magnitude (>= 1) relative
    (f32 sums in another order; for bf16, then a cast that may land one
    ulp of the largest |out| away), m and l of the live slots within 1e-4 relative, the rebuilt
    softmax row within 1e-5, exact zeros on the empty slot.  The hi segment
    also comes with no valid slot at all, and not at all."""
    gen = torch.Generator(device=dev).manual_seed(7)
    cache = _freelist_cache(dev, gen, dtype, page, lengths=[150, 0, 37, 90])
    q = _randn(gen, 4, 8, 16, dtype=dtype, dev=dev)
    segs = pq_ops.layer_segments(cache)
    assert [(o["k_bits"], o["v_bits"]) for o in segs] == [(4, 4), (2, 2), (16, 16)]
    if hi == "all-empty":
        segs[0] = dict(segs[0], pos=torch.full_like(segs[0]["pos"], -1))
    elif hi == "absent":
        segs = segs[1:]
    before = pq_kernel.KERNEL.launches
    out, m, l, p, m_run = pq_kernel.qattn_paged_layer(q, segs, scale=0.25,
                                                      want_weights=want_weights)
    assert pq_kernel.KERNEL.launches == before + 1
    rout, rm, rl, rp = pq_ref.paged_layer_ref(q, segs, scale=0.25)
    live = torch.tensor([True, False, True, True], device=dev)
    assert out.dtype == q.dtype
    tol_out = 2 ** -7 if q.dtype == torch.bfloat16 else 1e-4
    for a, w, t in ((out.float(), rout.float(), tol_out), (m, rm, 1e-4), (l, rl, 1e-4)):
        a, w = a[live], w[live]
        torch.testing.assert_close(a, w, atol=t * max(w.abs().max().item(), 1.0), rtol=0)
    assert not l[1].any() and not out[1].float().any() and torch.equal(m[1], rm[1])
    if want_weights:
        assert p.shape == rp.shape
        torch.testing.assert_close(p * torch.exp(m_run - m[..., None]), rp, atol=1e-5,
                                   rtol=1e-5)
    else:
        assert p is None and m_run is None


def test_paged_attend_matches_gather_path(dev):
    """The whole page walk (three segments, merged) against the gather path:
    outputs within 1e-4 on the live rows, zeros on the empty row."""
    gen = torch.Generator(device=dev).manual_seed(5)
    cache = _freelist_cache(dev, gen, torch.bfloat16, 16, lengths=[150, 0, 37, 90])
    q = _randn(gen, 4, 8, 16, dtype=torch.bfloat16, dev=dev)
    before = pq_kernel.KERNEL.launches
    got = pq_ops.attend_paged(q, cache)
    assert pq_kernel.KERNEL.launches == before + 1  # one launch per decode layer
    want = kvc.attend_decode(q, cache.dense_view())
    live = torch.tensor([True, False, True, True], device=dev)
    torch.testing.assert_close(got.out[live].float(), want.out[live].float(), atol=2 ** -7,
                               rtol=2 ** -7)
    torch.testing.assert_close(got.slot_weights[live], want.slot_weights[live], atol=1e-5,
                               rtol=1e-5)
    assert not got.out[1].float().any()


def test_continuous_engine_runs_every_kernel(dev):
    """Smoke-width continuous run on the card over the free-list paged layout
    with the paged kernel: every kernel launches, no decode takes the gather
    path, every request ends with its budget, every page comes back."""
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    scfg = ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8,
                       backend="paged", paged_kernel=True, page_allocator="freelist",
                       pool_fraction=0.75)
    params = registry.materialize_params(cfg, seed=0, device=dev)
    kernels = (cst_kernel.KERNEL, pf_kernel.FLASH, pf_kernel.COLSUM, pq_kernel.KERNEL)
    before = [k.launches for k in kernels]
    gathers = paged.GATHER_DECODES.launches
    eng = ContinuousEngine(cfg, ccfg, scfg, params, device=dev)
    rng = np.random.default_rng(0)
    budgets = (12, 6, 12)
    rids = [eng.submit(Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                               max_new_tokens=m)) for n, m in zip((48, 20, 33), budgets)]
    res = eng.run()
    assert [len(res[r].tokens) for r in rids] == list(budgets)
    assert all(k.launches > n for k, n in zip(kernels, before))
    assert paged.GATHER_DECODES.launches == gathers
    eng._alloc.check_invariants()
    assert all(v["used"] == 0 for k, v in eng.pool_stats().items() if k in ("hi", "lo", "win"))


def test_continuous_engine_mixed_layout_runs_decode_qattn(dev):
    """Smoke-width continuous run on the card over the mixed layout, where
    decode takes `decode_qattn`'s layer kernel with slots admitted, retired
    and empty in the batch: every kernel of the path launches, one
    `decode_qattn` launch per layer per non-probe step, and every request
    ends with its budget."""
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    scfg = ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12)
    params = registry.materialize_params(cfg, seed=0, device=dev)
    kernels = (cst_kernel.KERNEL, pf_kernel.FLASH, pf_kernel.COLSUM, dq_kernel.KERNEL)
    before = [k.launches for k in kernels]
    eng = ContinuousEngine(cfg, ccfg, scfg, params, device=dev)
    rng = np.random.default_rng(1)
    budgets = (12, 6, 12)
    rids = [eng.submit(Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                               max_new_tokens=m)) for n, m in zip((48, 20, 33), budgets)]
    res = eng.run()
    assert [len(res[r].tokens) for r in rids] == list(budgets)
    assert all(k.launches > n for k, n in zip(kernels, before))
    assert (dq_kernel.KERNEL.launches - before[3]) % cfg.n_layers == 0


# ---- captured decode steps (launch/steps.py) --------------------------------

CAPTURE_LAYOUTS = {"mixed": dict(backend="mixed"),
                   "paged-kernel": dict(backend="paged", page_size=8, paged_kernel=True)}


def _smoke(dev, **kw):
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = registry.materialize_params(cfg, seed=0, device=dev)
    return cfg, ccfg, params, ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12, **kw)


def _smoke_batch(cfg):
    rng = np.random.default_rng(0)
    return pack_requests([rng.integers(2, cfg.vocab, size=48) for _ in range(2)], 2, 48)


def _close(got, want):
    """Within one bf16 ulp of the largest value: a replay may take other
    cuBLAS algorithms than the eager run."""
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2 ** -7 * max(want.float().abs().max().item(), 1.0))


@pytest.mark.parametrize("layout", list(CAPTURE_LAYOUTS))
def test_captured_decode_layer_matches_eager(dev, layout):
    """One decode layer, non-probe, captured as a CUDA graph after a warm-up
    on the capture stream, replayed: its output and new window metadata
    against the eager call on the same cache."""
    cfg, ccfg, params, scfg = _smoke(dev, **CAPTURE_LAYOUTS[layout])
    eng = ServingEngine(cfg, ccfg, scfg, params, device=dev, capture=False)
    with torch.inference_mode():
        logits, caches = eng._prefill(params, {"tokens": torch.as_tensor(_smoke_batch(cfg),
                                                                         device=dev)})
        x = common.embed_lookup(params["embed"], torch.argmax(logits, -1))
        lp = common.layer_slice(params["groups"]["sub0"], 0)
        el = caches["groups"][0]["sub0"]
        want, want_el = blocks.apply_layer_decode(lp, x, cfg, "attn", "dense", el, eng.ctx,
                                                  False)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            blocks.apply_layer_decode(lp, x, cfg, "attn", "dense", el, eng.ctx, False)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            got, got_el = blocks.apply_layer_decode(lp, x, cfg, "attn", "dense", el, eng.ctx,
                                                    False)
        graph.replay()
        torch.cuda.synchronize()
    _close(got, want)
    for name in ("win_pos", "length", "win_fill"):
        assert torch.equal(getattr(got_el, name), getattr(want_el, name))


@pytest.mark.parametrize("layout", list(CAPTURE_LAYOUTS))
def test_captured_serve_step_matches_eager(dev, layout):
    """The lockstep engine's decode steps, captured and replayed, against
    the eager engine's from the same prefill, step by step through a probe
    step and a fold: logits within bf16 noise.  The captured step is built
    once and every non-probe step after the warm-up is a replay."""
    cfg, ccfg, params, scfg = _smoke(dev, **CAPTURE_LAYOUTS[layout])
    toks = torch.as_tensor(_smoke_batch(cfg), device=dev)
    runs = []
    for capture in (True, False):
        eng = ServingEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
        seen = []
        with torch.inference_mode():
            logits, caches = eng._prefill(params, {"tokens": toks})
            caches = eng._decode.adopt(caches)
            tok = torch.argmax(logits, -1).to(torch.int32)
            for i in range(12):
                logits, caches = eng._decode(params, caches, tok, eng._is_probe(i))
                seen.append(logits.clone())
                tok = eng._decode.token
                if i == 7:
                    caches = eng._decode.adopt(eng._recompress(caches))
        torch.cuda.synchronize()
        runs.append((eng._decode, seen))
    (step, got), (_, want) = runs
    for a, w in zip(got, want):
        _close(a, w)
    n_probe = sum(probe_flag(i, 8) for i in range(12))
    assert 0 < n_probe and step.captures == 1 and step.replays == 12 - n_probe - 1


class _ActiveLogits:
    """A continuous decode step that keeps every call's logits of the
    active rows (an inactive row's logits are never read)."""

    def __init__(self, step):
        self.step, self.logits = step, []

    def __call__(self, params, caches, staged):
        logits, caches = self.step(params, caches, staged)
        self.logits.append(logits[np.flatnonzero(staged[steps_lib.ROW_ACT]).tolist()].clone())
        return logits, caches

    def __getattr__(self, name):
        return getattr(self.step, name)


def test_captured_continuous_engine_matches_eager(dev):
    """The continuous engine's captured decode step against capture=False,
    step by step on the free-list paged layout through admissions, a
    watermark deferral, slot folds, probe steps and retirements: the active
    rows' logits within one bf16 ulp at every step, every greedy token
    equal.  Each fold, admission and retirement rewrites the static tree or
    the page tables between replays, so a leaf or a table left stale there
    shows at the steps after it."""
    cfg, ccfg, params, _ = _smoke(dev)
    scfg = ServeConfig(batch_size=2, prompt_len=32, max_new_tokens=12, backend="paged",
                       page_size=8, page_allocator="freelist", pool_fraction=1.0,
                       admit_watermark=0.25, paged_kernel=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=(24,)).astype(np.int32) for _ in range(3)]
    runs = []
    for capture in (False, True):
        eng = ContinuousEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
        rec = _ActiveLogits(eng._decode_masked)
        eng._decode_masked = rec
        rids = [eng.submit(Request(tokens=prompts[0])),
                eng.submit(Request(tokens=prompts[1], max_new_tokens=6))]
        for _ in range(4):
            eng.step()
        rids.append(eng.submit(Request(tokens=prompts[2])))   # defers, then admits
        res = eng.run()
        torch.cuda.synchronize()
        st = eng.pool_stats()
        assert st["admissions"] == 3 and st["deferrals"] >= 1 and st["folds"] >= 1
        assert [len(res[r].tokens) for r in rids] == [12, 6, 12]
        runs.append((rec, [res[r].tokens.tolist() for r in rids]))
    (eager, want_tokens), (cap, got_tokens) = runs
    assert cap.step.captures == 1 and cap.step.replays > 0
    assert got_tokens == want_tokens
    assert len(cap.logits) == len(eager.logits)
    for a, w in zip(cap.logits, eager.logits):
        _close(a, w)


def test_replays_count_the_capture_launches(dev):
    """Launch counters under capture: each replay adds what the capture
    counted.  Continuous (paged walk): one paged_qattn launch per layer per
    step; lockstep (mixed): one decode_qattn launch per layer per non-probe
    step, as the eager engines count."""
    cfg, ccfg, params, scfg = _smoke(dev, backend="paged", page_size=8, paged_kernel=True,
                                     page_allocator="freelist", pool_fraction=0.75)
    eng = ContinuousEngine(cfg, ccfg, scfg, params, device=dev)
    before = pq_kernel.KERNEL.launches
    rng = np.random.default_rng(0)
    rids = [eng.submit(Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                               max_new_tokens=m)) for n, m in ((48, 12), (20, 6), (33, 12))]
    res = eng.run()
    assert [len(res[r].tokens) for r in rids] == [12, 6, 12]
    step = eng._decode_masked
    assert step.captures == 1 and step.replays > 0
    assert pq_kernel.KERNEL.launches - before == cfg.n_layers * eng._step_no

    cfg, ccfg, params, scfg = _smoke(dev)
    eng = ServingEngine(cfg, ccfg, scfg, params, device=dev)
    before = dq_kernel.KERNEL.launches
    eng.generate({"tokens": _smoke_batch(cfg)})
    n_probe = sum(probe_flag(i, 8) for i in range(12))
    assert eng._decode.replays > 0
    assert dq_kernel.KERNEL.launches - before == cfg.n_layers * (12 - n_probe)


def test_cst_quant_store_captures(dev):
    """cst_quant's store, a thread-block cluster launched through
    `cudaLaunchKernelEx`, inside a CUDA graph (the folds' kernel, which a
    later capture of the folds needs): the replay equals the eager launch
    bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(3)
    b, hk, l, s, d = 4, 4, 300, 256, 128
    k = _randn(gen, b, hk, l, d, dtype=torch.bfloat16, scale=2.0)
    v = _randn(gen, b, hk, l, d, dtype=torch.bfloat16)
    idx = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    for row in range(b):
        idx[row, :200] = torch.randperm(l, generator=gen, device=dev)[:200].int()
    want = cst_kernel.quantize_store(k, v, idx, 2)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        cst_kernel.quantize_store(k, v, idx, 2)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = cst_kernel.quantize_store(k, v, idx, 2)
    graph.replay()
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_failed_capture_raises(dev, monkeypatch):
    """A step body that syncs with the host cannot be captured: the second
    non-probe step (the capture) raises `CaptureError`, nothing falls back
    to the eager path, and the card stays usable."""
    cfg, ccfg, params, scfg = _smoke(dev)
    eng = ServingEngine(cfg, ccfg, scfg, params, device=dev)
    decode = registry.decode_step

    def syncing(*args, **kw):
        logits, caches = decode(*args, **kw)
        logits.sum().item()
        return logits, caches

    monkeypatch.setattr(registry, "decode_step", syncing)
    with pytest.raises(steps_lib.CaptureError, match="serve_step"):
        eng.generate({"tokens": _smoke_batch(cfg)}, max_new_tokens=2)
    assert eng._decode.captures == 0 and eng._decode.replays == 0
    torch.cuda.synchronize()
    assert torch.ones(4, device=dev).sum().item() == 4.0


# ---- slice 7: the eff operand of cst_quant, precision maps, swap, ladder ----

@pytest.mark.parametrize("split", [None, 1], ids=["cluster", "one-cta"])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d", [(4, 461, 128), (1, 691, 128), (4, 37, 64)])
def test_quantize_store_eff_matches_plain(dev, b, s, d, dtype, bits, split):
    """One store with an eff table (mixed per (batch row, kv head, tensor),
    about a third of the entries at the container width) through the
    kernel's qmax instantiation, in one launch, equals its plain version on
    the card and on the CPU bit for bit; the container-width entries' slices
    equal the static launch's."""
    gen = torch.Generator(device=dev).manual_seed(11)
    hk, l = 4, s + 50
    k = _randn(gen, b, hk, l, d, dtype=dtype, scale=2.0)
    v = _randn(gen, b, hk, l, d, dtype=dtype)
    idx = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    for row in range(b):
        n_live = s - (s // 5) * (row % 2)
        idx[row, :n_live] = torch.randperm(l, generator=gen, device=dev)[:n_live].int()
    eff = torch.randint(1, bits + 1, (b, hk, 2), generator=gen, device=dev).float()
    eff.view(-1)[::3] = float(bits)
    before = cst_kernel.KERNEL.launches
    got = cst_kernel.quantize_store(k, v, idx, bits, split=split, eff=eff)
    assert cst_kernel.KERNEL.launches == before + 1
    want = cst_ref.quantize_store_ref(k, v, idx, bits, eff)
    on_cpu = cst_ref.quantize_store_ref(k.cpu(), v.cpu(), idx.cpu(), bits, eff.cpu())
    static = cst_kernel.quantize_store(k, v, idx, bits, split=split)
    names = ("k_codes", "k_scale", "k_zero", "v_codes", "v_scale", "v_zero", "v_cscale")
    full = eff == bits
    for i, (name, a, w, c, st) in enumerate(zip(names, got, want, on_cpu, static)):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, w), name
        assert torch.equal(a.cpu(), c), name
        tensor = 0 if i < 3 else 1
        sel = full[..., tensor]
        assert torch.equal(a[sel], st[sel]), name
    assert sel.any() and not full.all()


def _lever_engines(dev, capture, **kw):
    cfg, ccfg, params, _ = _smoke(dev)
    scfg = ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12, backend="paged",
                       page_size=8, page_allocator="freelist", paged_kernel=True, **kw)
    return cfg, ContinuousEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)


def _run_swap_scenario(eng, prompts):
    rids = [eng.submit(Request(tokens=prompts[0])), eng.submit(Request(tokens=prompts[1]))]
    events = []
    for _ in range(4):
        events += eng.step()
    rids.append(eng.submit(Request(tokens=prompts[2], max_new_tokens=3, priority=2)))
    while eng.pending:
        events += eng.step()
    return rids, events


def _run_ladder_scenario(eng, prompts):
    rids = [eng.submit(Request(tokens=prompts[0])),
            eng.submit(Request(tokens=prompts[1], max_new_tokens=6))]
    events = []
    for _ in range(4):
        events += eng.step()
    rids.append(eng.submit(Request(tokens=prompts[2])))
    while eng.pending:
        events += eng.step()
    return rids, events


def test_mapped_engine_launches_cst_quant_and_no_torch_quantizer(dev, monkeypatch):
    """Under a precision map and an armed ladder (pressured: downshifts
    fire), every store of every admission and fold goes through the
    kernel's qmax instantiation: the torch quantizers are never called, and
    cst_quant launches twice per layer per admission and per slot fold."""
    cfg, eng = _lever_engines(dev, True, pool_fraction=1.0, ladder_watermark=0.6,
                              precision_map="default=k8v8;layer:1-=k3v3")

    def no_torch_quantizer(*a, **kw):
        raise AssertionError("a torch quantizer ran on the card's path")

    monkeypatch.setattr(kvc, "build_store", no_torch_quantizer)
    for scheme in ("channelwise", "cst"):
        monkeypatch.setitem(kvc.quant._SCHEMES, scheme, no_torch_quantizer)
    before = cst_kernel.KERNEL.launches
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=(48,)).astype(np.int32) for _ in range(3)]
    rids, events = _run_ladder_scenario(eng, prompts)
    torch.cuda.synchronize()
    st = eng.pool_stats()
    assert st["downshift"]["downshifts"] >= 1
    assert all(eng.result(r).finish_reason == "length" for r in rids)
    assert cst_kernel.KERNEL.launches - before == \
        2 * cfg.n_layers * (st["admissions"] + st["folds"])


@pytest.mark.parametrize("scenario", ["swap", "ladder"])
def test_replay_after_swap_in_and_downshift_matches_eager(dev, scenario):
    """After a swap-in (the restore writes the static tree) and after a
    downshift (an early fold at a rung), every step of the captured engine
    equals the eager engine's step of the same index bit for bit, the step
    is built once (no recapture), and the tokens agree."""
    vocab = configs.get_arch("yi-6b", smoke=True).vocab
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab, size=(48,)).astype(np.int32) for _ in range(3)]
    runs = []
    for capture in (False, True):
        if scenario == "swap":
            cfg, eng = _lever_engines(dev, capture, pool_fraction=1.0, scheduler="priority",
                                      preemption="swap")
        else:
            cfg, eng = _lever_engines(dev, capture, pool_fraction=1.0, ladder_watermark=0.6,
                                      precision_map="default=k8v8;layer:1-=k3v3")
        rec = _ActiveLogits(eng._decode_masked)
        eng._decode_masked = rec
        run = _run_swap_scenario if scenario == "swap" else _run_ladder_scenario
        rids, events = run(eng, prompts)
        torch.cuda.synchronize()
        kinds = {type(e).__name__ for e in events}
        assert ("SwappedEvent" if scenario == "swap" else "DownshiftEvent") in kinds
        st = eng.pool_stats()
        if scenario == "swap":
            assert st["swap"]["swaps_in"] >= 1 and st["swap"]["host_bytes"] == 0
        runs.append((rec, [eng.result(r).tokens.tolist() for r in rids]))
    (eager, want_tokens), (cap, got_tokens) = runs
    assert cap.step.captures == 1 and cap.step.replays > 0
    assert got_tokens == want_tokens
    assert len(cap.logits) == len(eager.logits)
    for a, w in zip(cap.logits, eager.logits):
        assert torch.equal(a, w)


def test_copy_pages_in_place_matches_plain(dev):
    """The copy-on-write copy on the card: every pool is written in place
    (the same tensors, the same storage), sink-padded id vectors included,
    and equals its plain version (one page at a time on the CPU, every
    source read before any write) bit for bit, with the moves chained
    (a page is both a destination and the next move's source); the tables
    are untouched."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cache = _freelist_cache(dev, gen, torch.bfloat16, 16, (150, 90, 0, 40))
    caches = {"prefix": [], "groups": [{"sub0": cache}]}
    pools = {"hi": (cache.hi.k_pages, cache.hi.v_pages), "lo": (cache.lo.k_pages,
                                                                  cache.lo.v_pages),
             "win": (cache.win_k_pages, cache.win_v_pages)}
    rng = np.random.default_rng(0)
    moves, want = {}, {}
    for name, (k_pool, v_pool) in pools.items():
        sink = k_pool.shape[0] - 1
        n = min(3, sink // 2)
        ids = rng.permutation(sink)
        src, dst = ids[:n], ids[1:n + 1]
        pad = np.full(6, sink, np.int64)
        s_ids, d_ids = pad.copy(), pad.copy()
        s_ids[:n], d_ids[:n] = src, dst
        moves[name] = (torch.from_numpy(s_ids).to(dev), torch.from_numpy(d_ids).to(dev))
        want[name] = []
        for pool in (k_pool, v_pool):
            plain = pool.cpu().clone()
            before = pool.cpu()
            for a, b in zip(s_ids, d_ids):
                plain[b] = before[a]
            want[name].append(plain)
    ptrs = {n: [p.data_ptr() for p in ps] for n, ps in pools.items()}
    tables = [t.clone() for t in (cache.hi.table, cache.lo.table, cache.win_table)]
    with torch.inference_mode():
        out = registry.copy_caches(caches, moves)
    torch.cuda.synchronize()
    assert out is caches and out["groups"][0]["sub0"] is cache
    for name, ps in pools.items():
        assert [p.data_ptr() for p in ps] == ptrs[name]
        for pool, w in zip(ps, want[name]):
            assert torch.equal(pool.cpu(), w), name
    for t, w in zip((cache.hi.table, cache.lo.table, cache.win_table), tables):
        assert torch.equal(t, w)


def _shared_prompt_run(dev, capture, prefix_cache):
    cfg, ccfg, params, _ = _smoke(dev)
    scfg = ServeConfig(batch_size=2, prompt_len=32, max_new_tokens=12, backend="paged",
                       page_size=8, page_allocator="freelist", pool_fraction=1.5,
                       paged_kernel=True, prefix_cache=prefix_cache)
    eng = ContinuousEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
    rec = _ActiveLogits(eng._decode_masked)
    eng._decode_masked = rec
    shared = np.arange(2, 26, dtype=np.int32)
    rids = [eng.submit(Request(tokens=shared.copy())) for _ in range(3)]
    rids.append(eng.submit(Request(tokens=shared.copy(), max_new_tokens=4)))
    marks = []   # (step index, what happened before it): alias admissions, CoW copies
    while eng.pending:
        pf = eng.pool_stats()["prefix"]
        eng.step()
        after = eng.pool_stats()["prefix"]
        if after["hits"] > pf["hits"]:
            marks.append((len(rec.logits) - 1, "alias"))
        if after["cow_copies"] > pf["cow_copies"]:
            marks.append((len(rec.logits), "cow"))   # the fold ends the step
        eng._alloc.check_invariants()
    torch.cuda.synchronize()
    return eng, rec, [eng.result(r).tokens.tolist() for r in rids], marks


def test_replay_after_alias_and_cow_matches_eager(dev):
    """The shared-prompt scenario on the card (the page walk on): after an
    alias admission (the tables point at shared pages, the snapshot
    re-inserted) and after a CoW copy (pages copied in place, the table
    rewritten), every step of the captured engine equals the eager engine's
    step of the same index bit for bit; the step is built once; the tokens
    equal those with dedup off."""
    runs = [_shared_prompt_run(dev, capture, True) for capture in (False, True)]
    (_, eager, want_tokens, _), (eng, cap, got_tokens, marks) = runs
    st = eng.pool_stats()["prefix"]
    assert st["hits"] >= 1 and st["cow_copies"] >= 1, st
    assert {"alias", "cow"} <= {what for _, what in marks}
    assert cap.step.captures == 1 and cap.step.replays > 0
    assert got_tokens == want_tokens == _shared_prompt_run(dev, True, False)[2]
    assert len(cap.logits) == len(eager.logits)
    for a, w in zip(cap.logits, eager.logits):
        assert torch.equal(a, w)
    assert all(i < len(cap.logits) for i, _ in marks)


# ---------------------------------------------------------------------------
# seeded sampling on the card
# ---------------------------------------------------------------------------

def test_device_bits_equal_numpy(dev):
    """The device threefry (int64 arithmetic) gives the numpy threefry's
    32-bit draws bit for bit: 16 (seed, counter) pairs, seed -5 among them,
    over 64000 columns."""
    from repro_torch.core import prng
    seeds = [-5, 0, 7, 2**31 - 1, 11, 12, 13, 14, -2**31, 1, 2, 3, 99, 12345, -77, 5]
    ctrs = [0, 1, 3, 1024, 0, 5, 127, 128, 7, 0, 1, 2, 511, 40, 9, 100]
    keys = prng.fold_in(prng.key(torch.tensor(seeds, dtype=torch.int32, device=dev)),
                        torch.tensor(ctrs, dtype=torch.int32, device=dev))
    got = prng.random_bits32(keys, 64000).cpu().numpy()
    for row, s, c in zip(got, seeds, ctrs):
        want = sal._random_bits32(sal._fold_in(sal._key(s), c), 64000).astype(np.int64)
        np.testing.assert_array_equal(row, want)


def _sampled_run(dev, capture, sampled=True):
    """Two slots on the paged free list with the page walk; a sampled and a
    greedy request, then a third (sampled) admitted mid-run: -> (engine,
    active-row logits per step, tokens per request)."""
    from repro_torch.serving import SamplingParams
    cfg, ccfg, params, _ = _smoke(dev)
    scfg = ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12, backend="paged",
                       page_size=8, page_allocator="freelist", pool_fraction=1.0,
                       paged_kernel=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=(40,)).astype(np.int32) for _ in range(3)]
    sp = (lambda t, s: SamplingParams(temperature=t, seed=s)) if sampled else (
        lambda t, s: SamplingParams())
    eng = ContinuousEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
    rec = _ActiveLogits(eng._decode_masked)
    eng._decode_masked = rec
    rids = [eng.submit(Request(tokens=prompts[0], sampling=sp(0.7, 11))),
            eng.submit(Request(tokens=prompts[1], max_new_tokens=6))]
    for _ in range(3):
        eng.step()
    rids.append(eng.submit(Request(tokens=prompts[2], sampling=sp(1.0, -5))))
    res = eng.run()
    torch.cuda.synchronize()
    return eng, rec, [res[r].tokens.tolist() for r in rids]


def test_captured_sampled_step_matches_eager(dev):
    """With sampled rows: every step's logits bitwise the eager engine's,
    every token equal; the step builds two graphs (the decode step and its
    sampler), the sampler's replayed; a replayed draw is bitwise the
    sampler run eagerly on the same logits."""
    from repro_torch.core.prng import sample_tokens
    _, eager, want = _sampled_run(dev, False)
    eng, cap, got = _sampled_run(dev, True)
    assert got == want
    assert len(cap.logits) == len(eager.logits)
    for a, w in zip(cap.logits, eager.logits):
        assert torch.equal(a, w)
    step = cap.step
    assert step.captures == 2 and step.replays > 0 and step.sample_replays > 0
    with torch.inference_mode():
        replayed = step.sample(step._out).clone()
        eager_draw = sample_tokens(step._out.clone(), *steps_lib.sampling_rows(step.staged))
    assert torch.equal(replayed, eager_draw)


def test_greedy_only_step_graph_unchanged(dev):
    """All-greedy traffic builds one graph and runs no sampler; with sampled
    rows the decode graph is still built once (beside the sampler's), and
    the greedy request's tokens are the all-greedy run's."""
    from repro_torch.core.prng import SAMPLES
    before = SAMPLES.launches
    eng, _, greedy = _sampled_run(dev, True, sampled=False)
    step = eng._decode_masked.step
    assert SAMPLES.launches == before
    assert step.captures == 1 and step._sample_graph is None and step.sample_replays == 0
    eng, _, mixed = _sampled_run(dev, True)
    assert SAMPLES.launches > before
    assert mixed[1] == greedy[1] and mixed[0] != greedy[0]
    step = eng._decode_masked.step
    assert step.captures == 2 and step._sample_graph is not None


# ---------------------------------------------------------------------------
# the baseline policies and the levers on the card
# ---------------------------------------------------------------------------

BASELINES = ("mikv", "h2o", "fp16", "gear", "kivi")


@pytest.mark.parametrize("policy", BASELINES)
def test_baseline_engine_matches_eager_and_plain(dev, policy):
    """A baseline policy's lockstep run on the card (smoke width, a fold and
    probe steps in 12 tokens): every captured step's logits within one bf16
    ulp of the eager step's, tokens equal; the prefill logits within bf16
    noise of the plain versions'; `decode_qattn` on the non-probe steps of
    fp16 and h2o (raw stores), the plain route (`PLAIN_DECODES`) on every
    step of mikv, gear and kivi; the step built again after the first fold
    where it promotes the stores (all but mikv)."""
    cfg, _, params, scfg = _smoke(dev)
    ccfg = dataclasses.replace(CompressionConfig.preset(policy), fp_window=8,
                               recompress_interval=8)
    batch = {"tokens": _smoke_batch(cfg)}
    runs = {}
    for capture in (True, False):
        eng = ServingEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
        counters = (dq_kernel.KERNEL, backend_lib.PLAIN_DECODES, cst_kernel.KERNEL)
        before = [c.launches for c in counters]
        seen, step = [], eng._decode
        eng._decode = _Keep(step, seen)
        out = eng.generate(batch)
        torch.cuda.synchronize()
        runs[capture] = (out["tokens"], seen, [c.launches - n for c, n in zip(counters, before)],
                         step)
    (tok_c, got, launches, step), (tok_e, want, _, _) = runs[True], runs[False]
    assert (tok_c == tok_e).all()
    for a, w in zip(got, want):
        _close(a, w)
    n_layers, n_probe = cfg.n_layers, sum(probe_flag(i, 8) for i in range(12))
    walks = policy in ("h2o", "fp16")
    assert launches == [n_layers * (12 - n_probe) if walks else 0,
                        n_layers * (n_probe if walks else 12), 0]
    assert step.captures == (1 if policy == "mikv" else 2)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    lk, _ = registry.prefill(params, {"tokens": tokens}, cfg,
                             ServingEngine(cfg, ccfg, scfg, params, device=dev).ctx)
    lp, _ = registry.prefill(params, {"tokens": tokens}, cfg,
                             ServingEngine(cfg, ccfg, scfg, params, device=dev,
                                           use_kernels=False).ctx)
    assert (lk.float() - lp.float()).abs().max() <= 2 ** -6 * lp.float().abs().max()


class _Keep:
    """A lockstep decode step that keeps every call's logits."""

    def __init__(self, step, seen):
        self.step, self.seen = step, seen

    def __call__(self, *args):
        logits, caches = self.step(*args)
        self.seen.append(logits.clone())
        return logits, caches

    def __getattr__(self, name):
        return getattr(self.step, name)


@pytest.mark.parametrize("policy", BASELINES + ("zipcache",))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_gate_per_store(dev, policy, dtype):
    """The mixed layout's decode gate reads each store: fp16's and h2o's raw
    stores (and zipcache's) reach `decode_qattn` on a non-probe step, within
    one bf16 ulp (bf16) or 1e-4 (f32) of the exact route; mikv, gear and
    kivi take the exact route, counted in `PLAIN_DECODES`."""
    gen = torch.Generator(device=dev).manual_seed(0)
    ccfg = dataclasses.replace(CompressionConfig.preset(policy), fp_window=8,
                               recompress_interval=8)
    k, v = (_randn(gen, 2, 2, 40, 16, dtype=dtype, dev=dev) for _ in range(2))
    s = torch.rand((2, 40), generator=gen, device=dev)
    be = backend_lib.of(ccfg)
    cache = be.compress_prefill(k, v, s if ccfg.uses_saliency else None, 60, dtype=dtype)
    cache = be.append(cache, k[:, :, 0], v[:, :, 0])
    q = _randn(gen, 2, 4, 16, dtype=dtype, dev=dev)
    before = (dq_kernel.KERNEL.launches, backend_lib.PLAIN_DECODES.launches)
    out = be.attend(q, cache, is_probe=False).out
    torch.cuda.synchronize()
    walks = policy in ("zipcache", "h2o", "fp16")
    assert (dq_kernel.KERNEL.launches - before[0],
            backend_lib.PLAIN_DECODES.launches - before[1]) == ((1, 0) if walks else (0, 1))
    want = kvc.attend_decode(q, cache).out
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=tol * max(want.float().abs().max().item(), 1.0))


def test_levers_on_the_card(dev):
    """`attend_decode(impl="int8_algebra")` against the exact route on a
    zipcache cache (out atol 2e-2 rtol 1e-2, slot weights 1e-3), and
    `blocked_attention(compact=True)` against the f32 route (outputs within
    2e-2), both on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    ccfg = CompressionConfig.zipcache()
    k, v = (_randn(gen, 2, 4, 300, 128, dtype=torch.bfloat16, dev=dev) for _ in range(2))
    cache = kvc.compress_prefill(ccfg, k, v, torch.rand((2, 300), generator=gen, device=dev),
                                 340)
    q = _randn(gen, 2, 32, 128, dtype=torch.bfloat16, dev=dev)
    ref, alg = kvc.attend_decode(q, cache), kvc.attend_decode(q, cache, impl="int8_algebra")
    torch.testing.assert_close(alg.out.float(), ref.out.float(), atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(alg.slot_weights, ref.slot_weights, atol=1e-3, rtol=0)
    qa = _randn(gen, 1, 32, 300, 128, dtype=torch.bfloat16, dev=dev)
    oc, _ = attention.blocked_attention(qa, k[:1], v[:1], compact=True)
    of, _ = attention.blocked_attention(qa, k[:1], v[:1])
    assert (oc.float() - of.float()).abs().max().item() <= 2e-2


# ---- MLA shapes (DeepSeek-V2-Lite): flash_fwd / probe_colsum at d 192, v 128;
# cst_quant over the 512-wide latent --------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lkv,d,dv", [(2, 16, 130, 130, 192, 128), (1, 16, 70, 200, 192, 128),
                                            (2, 4, 48, 48, 32, 16), (1, 4, 33, 70, 32, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_mla_matches_plain(dev, dtype, b, h, lq, lkv, d, dv, causal):
    """flash_fwd with a v head dim below the q/k one (MLA's prefill: q/k
    nope + rope, v v_head_dim; full width and smoke width), ragged lq and a
    diagonal offset: out (b, h, lq, dv) within 2**-7 of the plain version,
    LSE within 1e-5."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q = _randn(gen, b, h, lq, d, dtype=dtype)
    k = _randn(gen, b, h, lkv, d, dtype=dtype)
    v = _randn(gen, b, h, lkv, dv, dtype=dtype)
    out, lse = pf_kernel.flash_fwd(q, k, v, causal=causal)
    ref_out, ref_lse = pf_ref.flash_fwd_ref(q, k, v, causal=causal)
    assert out.shape == (b, h, lq, dv)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2 ** -7, rtol=2 ** -7)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)


def test_flash_fwd_rejects_other_head_dim_pairs(dev):
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k = _randn(gen, 1, 4, 8, 64), _randn(gen, 1, 4, 8, 64)
    with pytest.raises(ValueError, match="head dims"):
        pf_kernel.flash_fwd(q, k, _randn(gen, 1, 4, 8, 32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 4])
def test_probe_colsum_mla_matches_plain(dev, dtype, b):
    """probe_colsum at MLA's q/k head dim 192, 16 heads of one kv head each
    (the materialized rope-key broadcast), the probe rows of
    select_probes(1024): within 1e-4 of the plain version, bitwise across
    two calls."""
    gen = torch.Generator(device=dev).manual_seed(13)
    h, l, d = 16, 1024, 192
    q, k = _randn(gen, b, h, l, d, dtype=dtype), _randn(gen, b, h, l, d, dtype=dtype)
    _, lse = pf_ref.flash_fwd_ref(q, k, k)
    pos = pf_ops.unique_probe_rows(sal.select_probes(l).positions.to(dev))
    safe = pos.clamp(0, l - 1).long()
    args = (q[:, :, safe].contiguous(), lse[:, :, safe].contiguous(),
            pos[None].expand(b, -1).contiguous(), k)
    got = pf_kernel.probe_colsum(*args, lq=l)
    torch.testing.assert_close(got, pf_ref.probe_colsum_ref(*args, lq=l), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, pf_kernel.probe_colsum(*args, lq=l))


@pytest.mark.parametrize("eff", [False, True], ids=["static", "eff"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(4, 461), (1, 37)])
def test_quantize_store_mla_matches_plain(dev, b, s, dtype, bits, eff):
    """One MLA cache store: one kv head, K the 64-wide rope key
    (channelwise), V the 512-wide latent (CST, several code words a
    thread), static and through an eff table: codes and parameters bitwise
    the plain version's on the card and on the CPU."""
    gen = torch.Generator(device=dev).manual_seed(14)
    l = s + 50
    k = _randn(gen, b, 1, l, 64, dtype=dtype, scale=2.0)
    v = _randn(gen, b, 1, l, 512, dtype=dtype)
    idx = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    for row in range(b):
        idx[row, :s - s // 5] = torch.randperm(l, generator=gen, device=dev)[:s - s // 5].int()
    table = None
    if eff:
        table = torch.randint(1, bits + 1, (b, 1, 2), generator=gen, device=dev).float()
        table.view(-1)[::3] = float(bits)
    got = cst_kernel.quantize_store(k, v, idx, bits, eff=table)
    want = cst_ref.quantize_store_ref(k, v, idx, bits, table)
    on_cpu = cst_ref.quantize_store_ref(k.cpu(), v.cpu(), idx.cpu(), bits,
                                        None if table is None else table.cpu())
    names = ("k_codes", "k_scale", "k_zero", "v_codes", "v_scale", "v_zero", "v_cscale")
    for name, a, w, c in zip(names, got, want, on_cpu):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, w), name
        assert torch.equal(a.cpu(), c), name


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cst_quant_rows_512_exact(dev, bits):
    gen = torch.Generator(device=dev).manual_seed(15)
    x = _randn(gen, 3, 77, 512, dtype=torch.bfloat16, scale=2.0)
    c = torch.sqrt(x.float().abs().amax(dim=1).double()).float().clamp_min(1e-4)
    for a, w in zip(cst_kernel.cst_quant_rows(x, c, bits), cst_ref.cst_quant_rows_ref(x, c, bits)):
        assert torch.equal(a, w)


def _deepseek_smoke(dev, **kw):
    cfg = configs.get_arch("deepseek-v2-lite-16b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = registry.materialize_params(cfg, seed=0, device=dev)
    return cfg, ccfg, params, ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12, **kw)


@pytest.mark.parametrize("layout", list(CAPTURE_LAYOUTS))
def test_deepseek_captured_serve_step_matches_eager(dev, layout):
    """DeepSeek-V2-Lite smoke (an MLA prefix layer, MLA + MoE groups) on the
    lockstep engine: the captured decode steps against the eager ones from
    the same prefill through a probe step and a fold, logits within one bf16
    ulp; flash_fwd at (32, 16) and probe_colsum once per layer per prefill,
    cst_quant twice per layer per compression; no decode_qattn (MLA decodes
    through the plain route over the dense view)."""
    cfg, ccfg, params, scfg = _deepseek_smoke(dev, **CAPTURE_LAYOUTS[layout])
    toks = torch.as_tensor(_smoke_batch(cfg), device=dev)
    runs = []
    for capture in (True, False):
        eng = ServingEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
        counts = [k.launches for k in (pf_kernel.FLASH, pf_kernel.COLSUM, cst_kernel.KERNEL,
                                       dq_kernel.KERNEL, pq_kernel.KERNEL)]
        seen = []
        with torch.inference_mode():
            logits, caches = eng._prefill(params, {"tokens": toks})
            caches = eng._decode.adopt(caches)
            tok = torch.argmax(logits, -1).to(torch.int32)
            for i in range(12):
                logits, caches = eng._decode(params, caches, tok, eng._is_probe(i))
                seen.append(logits.clone())
                tok = eng._decode.token
                if i == 7:
                    caches = eng._decode.adopt(eng._recompress(caches))
        torch.cuda.synchronize()
        got = [k.launches - c for k, c in zip((pf_kernel.FLASH, pf_kernel.COLSUM,
                                               cst_kernel.KERNEL, dq_kernel.KERNEL,
                                               pq_kernel.KERNEL), counts)]
        assert got == [cfg.n_layers, cfg.n_layers, 4 * cfg.n_layers, 0, 0]
        runs.append((eng._decode, seen))
    (step, got), (_, want) = runs
    for a, w in zip(got, want):
        _close(a, w)
    assert step.captures == 1 and step.replays == 12 - sum(probe_flag(i, 8) for i in range(12)) - 1


# ---- Jamba's attention shapes (g = 4, hk = 8, d = 128) and the SSM models ----

JAMBA = "jamba-v0.1-52b"
HK, G, D = 8, 4, 128      # jamba-v0.1-52b's attention layer: 32 query heads over 8 kv heads


def test_cst_quant_at_jamba_shapes(dev):
    """Both stores of one Jamba attention layer's prefill (8 kv heads,
    d 128) in one launch each, bitwise the plain version."""
    gen = torch.Generator(device=dev).manual_seed(31)
    ccfg = CompressionConfig.zipcache()
    b, l = 2, 300
    k, v = (_randn(gen, b, HK, l, D, dtype=torch.bfloat16) for _ in range(2))
    s_hi, s_lo, _ = kvc.capacities(ccfg, l + 64)
    sal_idx, reg_idx = sal.salient_split(torch.rand((b, l), generator=gen, device=dev),
                                         ccfg.n_salient(l))
    for bits, cap, idx in ((ccfg.high_bits, s_hi, sal_idx), (ccfg.low_bits, s_lo, reg_idx)):
        idx = torch.nn.functional.pad(idx, (0, cap - idx.shape[1]), value=-1)
        before = cst_kernel.KERNEL.launches
        got = cst_kernel.quantize_store(k, v, idx, bits)
        assert cst_kernel.KERNEL.launches == before + 1
        for a, w in zip(got, cst_ref.quantize_store_ref(k, v, idx, bits)):
            assert a.dtype == w.dtype and torch.equal(a, w)


@pytest.mark.parametrize("b,lq", [(2, 300), (1, 1024)])
def test_flash_fwd_and_probe_colsum_at_jamba_shapes(dev, b, lq):
    """flash_fwd at 32 / 8 heads (g = 4), d 128, bf16: out within one bf16
    ulp of 1, LSE 1e-5; probe_colsum over its probe rows: 1e-4 and two
    calls bitwise."""
    gen = torch.Generator(device=dev).manual_seed(32)
    q = _randn(gen, b, HK * G, lq, D, dtype=torch.bfloat16)
    k, v = (_randn(gen, b, HK, lq, D, dtype=torch.bfloat16) for _ in range(2))
    out, lse = pf_kernel.flash_fwd(q, k, v)
    ref_out, ref_lse = pf_ref.flash_fwd_ref(q, k, v)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2 ** -7, rtol=2 ** -7)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    pos = pf_ops.unique_probe_rows(sal.select_probes(lq).positions.to(dev))
    safe = pos.clamp(0, lq - 1).long()
    args = (q[:, :, safe].contiguous(), lse[:, :, safe].contiguous(),
            pos[None].expand(b, -1).contiguous(), k)
    got = pf_kernel.probe_colsum(*args, lq=lq)
    torch.testing.assert_close(got, pf_ref.probe_colsum_ref(*args, lq=lq), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, pf_kernel.probe_colsum(*args, lq=lq))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_qattn_at_jamba_shapes(dev, dtype):
    """One `qattn_mixed_layer` launch (the walk's G = 4, D = 128
    instantiation) over a mixed cache of 8 kv heads: out within 1e-4 (f32)
    or one bf16 ulp (bf16) of its largest magnitude (>= 1)."""
    gen = torch.Generator(device=dev).manual_seed(33)
    ccfg = CompressionConfig.zipcache()
    b, l = 2, 300
    k, v = (_randn(gen, b, HK, l, D, dtype=dtype) for _ in range(2))
    cache = kvc.compress_prefill(ccfg, k, v, torch.rand((b, l), generator=gen, device=dev),
                                 l + 64, dtype=dtype)
    for _ in range(9):
        cache = kvc.append_token(cache, _randn(gen, b, HK, D, dtype=dtype),
                                 _randn(gen, b, HK, D, dtype=dtype))
    q = _randn(gen, b, HK * G, D, dtype=dtype)
    segs = dq_ops.mixed_segments(cache)
    before = dq_kernel.KERNEL.launches
    out = dq_kernel.qattn_mixed_layer(q, segs)
    assert dq_kernel.KERNEL.launches == before + 1
    want = dq_ref.mixed_layer_ref(q, segs)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(),
                               atol=tol * max(want.float().abs().max().item(), 1.0), rtol=0)


@pytest.mark.parametrize("want_weights", [True, False], ids=["weights", "no-weights"])
def test_paged_qattn_at_jamba_shapes(dev, want_weights):
    """One `qattn_paged_layer` launch over a free-list cache of 8 kv heads,
    d 128, pages of 64, an empty slot: out within one bf16 ulp of its
    largest magnitude, m and l 1e-4 relative, the slot weights 1e-5, zeros
    on the empty slot."""
    gen = torch.Generator(device=dev).manual_seed(34)
    cache = _freelist_cache(dev, gen, torch.bfloat16, 64, lengths=[300, 0, 97, 200], hk=HK,
                            d=D, max_len=400)
    q = _randn(gen, 4, HK * G, D, dtype=torch.bfloat16)
    segs = pq_ops.layer_segments(cache)
    scale = 1.0 / D ** 0.5
    before = pq_kernel.KERNEL.launches
    out, m, l, p, m_run = pq_kernel.qattn_paged_layer(q, segs, scale=scale,
                                                      want_weights=want_weights)
    assert pq_kernel.KERNEL.launches == before + 1
    rout, rm, rl, rp = pq_ref.paged_layer_ref(q, segs, scale=scale)
    live = torch.tensor([True, False, True, True], device=dev)
    for a, w, t in ((out.float(), rout.float(), 2 ** -7), (m, rm, 1e-4), (l, rl, 1e-4)):
        a, w = a[live], w[live]
        torch.testing.assert_close(a, w, atol=t * max(w.abs().max().item(), 1.0), rtol=0)
    assert not l[1].any() and not out[1].float().any()
    if want_weights:
        torch.testing.assert_close(p * torch.exp(m_run - m[..., None]), rp, atol=1e-5,
                                   rtol=1e-5)


def _hybrid_smoke(dev, arch):
    """mamba2 smoke, or Jamba smoke at 8 heads of 16 over 2 kv heads (g = 4
    on the walk)."""
    cfg = configs.get_arch(arch, smoke=True)
    if arch == JAMBA:
        cfg = dataclasses.replace(cfg, n_heads=8, head_dim=16)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    return cfg, ccfg, registry.materialize_params(cfg, seed=0, device=dev)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", JAMBA])
def test_hybrid_captured_steps_match_eager(dev, arch):
    """The SSM states through both engines' captured decode steps: the
    lockstep step (mixed) and the continuous step (Jamba: paged free list
    with the walk; mamba2: paged static), captured against capture=False
    through probe steps, folds, admissions and retirements.  Every step's
    logits bitwise the eager step's, tokens equal, each step built once and
    replayed."""
    cfg, ccfg, params = _hybrid_smoke(dev, arch)
    rng = np.random.default_rng(3)
    batch = pack_requests([rng.integers(2, cfg.vocab, size=n) for n in (48, 20)], 2, 48)
    prompts = [rng.integers(2, cfg.vocab, size=(n,)).astype(np.int32) for n in (40, 24, 33)]
    layout = (dict(backend="paged", page_size=8, page_allocator="freelist", paged_kernel=True)
              if arch == JAMBA else dict(backend="paged", page_size=8))
    runs = []
    for capture in (True, False):
        lock = ServingEngine(cfg, ccfg, ServeConfig(2, 48, 12), params, device=dev,
                             capture=capture)
        lock_rec = lock._decode = _Recorded(lock._decode)
        toks = lock.generate({"tokens": batch})["tokens"].tolist()
        cont = ContinuousEngine(cfg, ccfg, ServeConfig(2, 48, 12, **layout), params, device=dev,
                                capture=capture)
        cont_rec = cont._decode_masked = _ActiveLogits(cont._decode_masked)
        rids = [cont.submit(Request(tokens=p, max_new_tokens=m))
                for p, m in zip(prompts, (12, 4, 12))]
        res = cont.run()
        torch.cuda.synchronize()
        runs.append((toks, [res[r].tokens.tolist() for r in rids], lock_rec, cont_rec))
    (toks, ctoks, lock_cap, cont_cap), (want, cwant, lock_eag, cont_eag) = runs
    assert toks == want and ctoks == cwant
    for cap, eag in ((lock_cap, lock_eag), (cont_cap, cont_eag)):
        assert cap.step.captures == 1 and cap.step.replays > 0
        assert len(cap.logits) == len(eag.logits)
        for a, w in zip(cap.logits, eag.logits):
            assert torch.equal(a, w)


class _Recorded:
    """A lockstep decode step that keeps every call's logits."""

    def __init__(self, step):
        self.step, self.logits = step, []

    def __call__(self, *args):
        logits, caches = self.step(*args)
        self.logits.append(logits.clone())
        return logits, caches

    def __getattr__(self, name):
        return getattr(self.step, name)


# ---- seamless-m4t-medium: 16 heads over 16 kv heads (g = 1), d 64 ----------------
SEAMLESS = "seamless-m4t-medium"
HK1, D64 = 16, 64


@pytest.mark.parametrize("source", [torch.bfloat16, torch.float32], ids=["self", "cross"])
def test_cst_quant_at_seamless_shapes(dev, source):
    """The stores of one decoder layer at 16 kv heads, d 64, one launch each,
    bitwise the plain version: a self cache's from bf16 K / V (a 128-token
    prompt) and a cross cache's from the encoder memory's f32 K / V (1024
    source tokens, f32 parameters)."""
    gen = torch.Generator(device=dev).manual_seed(41)
    ccfg = CompressionConfig.zipcache()
    b, l = 2, 128 if source == torch.bfloat16 else 1024
    max_len = l + 64 if source == torch.bfloat16 else l
    k, v = (_randn(gen, b, HK1, l, D64, dtype=source) for _ in range(2))
    s_hi, s_lo, _ = kvc.capacities(ccfg, max_len)
    sal_idx, reg_idx = sal.salient_split(torch.rand((b, l), generator=gen, device=dev),
                                         ccfg.n_salient(l))
    for bits, cap, idx in ((ccfg.high_bits, s_hi, sal_idx), (ccfg.low_bits, s_lo, reg_idx)):
        idx = torch.nn.functional.pad(idx, (0, cap - idx.shape[1]), value=-1)
        before = cst_kernel.KERNEL.launches
        got = cst_kernel.quantize_store(k, v, idx, bits)
        assert cst_kernel.KERNEL.launches == before + 1
        for a, w in zip(got, cst_ref.quantize_store_ref(k, v, idx, bits)):
            assert a.dtype == w.dtype and torch.equal(a, w)
        assert got[1].dtype == source


@pytest.mark.parametrize("b,lq", [(4, 128), (1, 77)])
def test_flash_fwd_and_probe_colsum_at_seamless_shapes(dev, b, lq):
    """The decoder's causal self-attention prefill at 16 / 16 heads (g = 1),
    d 64, bf16: out within one bf16 ulp of 1, LSE 1e-5; probe_colsum over
    its probe rows: 1e-4 and two calls bitwise."""
    gen = torch.Generator(device=dev).manual_seed(42)
    q, k, v = (_randn(gen, b, HK1, lq, D64, dtype=torch.bfloat16) for _ in range(3))
    out, lse = pf_kernel.flash_fwd(q, k, v)
    ref_out, ref_lse = pf_ref.flash_fwd_ref(q, k, v)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2 ** -7, rtol=2 ** -7)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    pos = pf_ops.unique_probe_rows(sal.select_probes(lq).positions.to(dev))
    safe = pos.clamp(0, lq - 1).long()
    args = (q[:, :, safe].contiguous(), lse[:, :, safe].contiguous(),
            pos[None].expand(b, -1).contiguous(), k)
    got = pf_kernel.probe_colsum(*args, lq=lq)
    torch.testing.assert_close(got, pf_ref.probe_colsum_ref(*args, lq=lq), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, pf_kernel.probe_colsum(*args, lq=lq))


@pytest.mark.parametrize("cache", ["self", "cross"])
def test_decode_qattn_at_seamless_shapes(dev, cache):
    """One `qattn_mixed_layer` launch (the walk's G = 1, D = 64
    instantiation) over a self cache (bf16 stores, a partly filled window)
    and over a cross cache (f32 store parameters from f32 K / V over 1024
    source slots, beside an empty bf16 window, as the encoder-decoder's
    prefill builds it): out within one bf16 ulp of its largest magnitude
    (>= 1)."""
    gen = torch.Generator(device=dev).manual_seed(43)
    ccfg = CompressionConfig.zipcache()
    b = 4
    if cache == "self":
        l, max_len, src = 128, 256, torch.bfloat16
    else:
        l, max_len, src = 1024, 1024, torch.float32
    k, v = (_randn(gen, b, HK1, l, D64, dtype=src) for _ in range(2))
    c = kvc.compress_prefill(ccfg, k, v, torch.rand((b, l), generator=gen, device=dev),
                             max_len, dtype=torch.bfloat16, use_kernel=True)
    if cache == "self":
        for _ in range(9):
            c = kvc.append_token(c, _randn(gen, b, HK1, D64, dtype=src),
                                 _randn(gen, b, HK1, D64, dtype=src))
    segs = dq_ops.mixed_segments(c)
    assert [s["k_codes"].dtype for s in segs] == [torch.int8, torch.int8, torch.bfloat16]
    assert c.hi.k.scale.dtype == src and dq_ops.kernel_supported(c)
    q = _randn(gen, b, HK1, D64, dtype=torch.bfloat16)
    before = dq_kernel.KERNEL.launches
    out = dq_kernel.qattn_mixed_layer(q, segs)
    assert dq_kernel.KERNEL.launches == before + 1
    want = dq_ref.mixed_layer_ref(q, segs)
    torch.testing.assert_close(out.float(), want.float(),
                               atol=2 ** -7 * max(want.float().abs().max().item(), 1.0), rtol=0)


def test_encdec_captured_serve_step_matches_eager(dev):
    """seamless smoke on the lockstep engine, f32 source frames (cross stores
    with f32 parameters): the captured decode step against capture=False
    through probe steps and a fold, every step's logits bitwise the eager
    step's, tokens equal, the step built once and replayed; the non-probe
    steps read both caches of every layer through decode_qattn, and none
    takes the plain route."""
    cfg = configs.get_arch(SEAMLESS, smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = registry.materialize_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(5)
    # 160 source frames under a 128-token decoder prompt (min(128, 160))
    batch = {"tokens": rng.integers(2, cfg.vocab, size=(2, 128)).astype(np.int32),
             "frontend_embeds": rng.standard_normal((2, 160, cfg.d_model)).astype(np.float32)}
    max_new = 12
    n_probe = sum(probe_flag(i, ccfg.recompress_interval, 0) for i in range(max_new))
    runs = []
    for capture in (True, False):
        eng = ServingEngine(cfg, ccfg, ServeConfig(2, 160, max_new), params, device=dev,
                            capture=capture)
        eng._decode = _Recorded(eng._decode)
        dq_kernel.KERNEL.launches = backend_lib.PLAIN_DECODES.launches = 0
        toks = eng.generate(batch)["tokens"]
        torch.cuda.synchronize()
        runs.append((toks, eng._decode, dq_kernel.KERNEL.launches,
                     backend_lib.PLAIN_DECODES.launches))
        assert eng.last_caches["groups"][0]["cross"].hi.k.scale.dtype == torch.float32
    (toks, cap, launches, plain), (want, eag, e_launches, e_plain) = runs
    np.testing.assert_array_equal(toks, want)
    assert cap.step.captures == 1 and cap.step.replays > 0
    assert len(cap.logits) == len(eag.logits) == max_new
    for a, w in zip(cap.logits, eag.logits):
        assert torch.equal(a, w)
    per_step = 2 * cfg.n_layers
    assert launches == e_launches == per_step * (max_new - n_probe)
    assert plain == e_plain == per_step * n_probe


# ---- the remaining configs: the walk's G = 3 and G = 7, qwen2, smollm, yi-34b ------------
# (g, d): smollm g 3 d 64, qwen2 / yi-34b g 7 d 128, deepseek-moe g 1 d 128
NEW_WALK = [(1, 128), (3, 64), (3, 128), (7, 64), (7, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", NEW_WALK)
def test_mixed_layer_at_new_group_sizes(dev, g, d, dtype):
    """One `qattn_mixed_layer` launch (the walk's G = 3 / G = 7
    instantiations and G = 1 at D = 128, contiguous) over a mixed cache of 2 kv heads, bf16 or
    f32 stores, against the layer plain version: out within 1e-4 (f32) or
    one bf16 ulp (bf16) of its largest magnitude (>= 1); m and l of each
    store alone 1e-4 relative.  At G = 7 every row has its own softmax state
    (no lane owns two halves of a scatter)."""
    gen = torch.Generator(device=dev).manual_seed(40 + g)
    ccfg = CompressionConfig.zipcache()
    b, hk, l = 3, 2, 300
    k, v = (_randn(gen, b, hk, l, d, dtype=dtype) for _ in range(2))
    cache = kvc.compress_prefill(ccfg, k, v, torch.rand((b, l), generator=gen, device=dev),
                                 l + 64, dtype=dtype)
    for _ in range(9):
        cache = kvc.append_token(cache, _randn(gen, b, hk, d, dtype=dtype),
                                 _randn(gen, b, hk, d, dtype=dtype))
    q = _randn(gen, b, hk * g, d, dtype=dtype)
    segs = dq_ops.mixed_segments(cache)
    before = dq_kernel.KERNEL.launches
    out = dq_kernel.qattn_mixed_layer(q, segs)
    assert dq_kernel.KERNEL.launches == before + 1
    want = dq_ref.mixed_layer_ref(q, segs)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(),
                               atol=tol * max(want.float().abs().max().item(), 1.0), rtol=0)
    for store in (cache.hi, cache.lo):
        args = (q, store.k.codes, store.k.scale, store.k.zero, store.v.codes,
                store.v.channel_scale, store.v.scale, store.v.zero, store.pos,
                store.k.bits, store.v.bits)
        for a, w in zip(dq_kernel.qattn_segment(*args), dq_ref.qattn_segment_ref(*args)):
            torch.testing.assert_close(a, w, atol=1e-4 * max(w.abs().max().item(), 1.0), rtol=0)


@pytest.mark.parametrize("want_weights", [True, False], ids=["weights", "no-weights"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", NEW_WALK)
def test_paged_layer_at_new_group_sizes(dev, g, d, dtype, want_weights):
    """One `qattn_paged_layer` launch (G = 3 / G = 7, paged) over a free-list
    cache of 2 kv heads, pages of 16, an empty slot: out within 1e-4 (f32)
    or one bf16 ulp (bf16) of its largest magnitude, m and l 1e-4 relative,
    the rebuilt softmax rows 1e-5, zeros on the empty slot."""
    gen = torch.Generator(device=dev).manual_seed(50 + g)
    cache = _freelist_cache(dev, gen, dtype, 16, lengths=[150, 0, 37, 90], hk=2, d=d)
    q = _randn(gen, 4, 2 * g, d, dtype=dtype)
    segs = pq_ops.layer_segments(cache)
    scale = 1.0 / d ** 0.5
    before = pq_kernel.KERNEL.launches
    out, m, l, p, m_run = pq_kernel.qattn_paged_layer(q, segs, scale=scale,
                                                      want_weights=want_weights)
    assert pq_kernel.KERNEL.launches == before + 1
    rout, rm, rl, rp = pq_ref.paged_layer_ref(q, segs, scale=scale)
    live = torch.tensor([True, False, True, True], device=dev)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    for a, w, t in ((out.float(), rout.float(), tol), (m, rm, 1e-4), (l, rl, 1e-4)):
        a, w = a[live], w[live]
        torch.testing.assert_close(a, w, atol=t * max(w.abs().max().item(), 1.0), rtol=0)
    assert not l[1].any() and not out[1].float().any()
    if want_weights:
        torch.testing.assert_close(p * torch.exp(m_run - m[..., None]), rp, atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("layout", ["mixed", "paged"])
@pytest.mark.parametrize("g", [5, 6, 16])
def test_walk_refuses_group_sizes_outside_groups(dev, g, layout):
    """A group size the walk has no instantiation for raises a ValueError
    that names GROUPS, on the kernel and through the backend's decode: it is
    never routed to the plain version (PLAIN_DECODES and GATHER_DECODES stay
    as they were)."""
    from repro_torch.kernels import qattn_walk

    assert g not in qattn_walk.GROUPS
    gen = torch.Generator(device=dev).manual_seed(60)
    ccfg = CompressionConfig.zipcache()
    q = _randn(gen, 2 if layout == "mixed" else 4, g, 16, dtype=torch.bfloat16)
    if layout == "mixed":
        k, v = (_randn(gen, 2, 1, 80, 16, dtype=torch.bfloat16) for _ in range(2))
        be = backend_lib.of(ccfg, kind="mixed")
        cache = be.compress_prefill(k, v, torch.rand((2, 80), generator=gen, device=dev), 120)
        with pytest.raises(ValueError, match="GROUPS|h / hk"):
            dq_kernel.qattn_mixed_layer(q, dq_ops.mixed_segments(cache))
    else:
        cache = _freelist_cache(dev, gen, torch.bfloat16, 16, lengths=[60, 0, 37, 20], hk=1)
        be = backend_lib.of(ccfg, kind="paged", page_size=16, paged_kernel=True,
                            page_allocator="freelist", pool_fraction=0.75)
        with pytest.raises(ValueError, match="GROUPS|h / hk"):
            pq_kernel.qattn_paged_layer(q, pq_ops.layer_segments(cache), scale=0.25)
    counts = (backend_lib.PLAIN_DECODES.launches, paged.GATHER_DECODES.launches)
    with pytest.raises(ValueError, match="h / hk"):
        be.attend(q, cache, is_probe=False)
    assert (backend_lib.PLAIN_DECODES.launches, paged.GATHER_DECODES.launches) == counts


@pytest.mark.parametrize("h,hk,b,lq,d,hpc", [(56, 8, 4, 1024, 128, 7), (28, 4, 1, 300, 128, 1),
                                               (28, 4, 4, 1024, 128, 1), (15, 5, 2, 200, 64, 1),
                                               (15, 5, 4, 1024, 64, 1)],
                         ids=["yi34b-b4", "qwen2-b1", "qwen2-b4", "smollm-b2", "smollm-b4"])
def test_flash_fwd_and_probe_colsum_at_new_group_sizes(dev, h, hk, b, lq, d, hpc):
    """flash_fwd at g = 7 and g = 3, bf16: out within one bf16 ulp of 1, LSE
    1e-5; probe_colsum over select_probes' rows: 1e-4, two calls bitwise,
    and the heads per CTA the launch picked (7 at yi-34b's batch 4: 16
    column blocks x 8 x 4 = 512 CTAs; 1 where 7 or 3 heads a CTA would leave
    fewer than 512)."""
    gen = torch.Generator(device=dev).manual_seed(70)
    q = _randn(gen, b, h, lq, d, dtype=torch.bfloat16)
    k, v = (_randn(gen, b, hk, lq, d, dtype=torch.bfloat16) for _ in range(2))
    out, lse = pf_kernel.flash_fwd(q, k, v)
    ref_out, ref_lse = pf_ref.flash_fwd_ref(q, k, v)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2 ** -7, rtol=2 ** -7)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    pos = pf_ops.unique_probe_rows(sal.select_probes(lq).positions.to(dev))
    safe = pos.clamp(0, lq - 1).long()
    args = (q[:, :, safe].contiguous(), lse[:, :, safe].contiguous(),
            pos[None].expand(b, -1).contiguous(), k)
    pf_kernel.COLSUM.heads_per_cta = None
    got = pf_kernel.probe_colsum(*args, lq=lq)
    assert pf_kernel.COLSUM.heads_per_cta == hpc
    torch.testing.assert_close(got, pf_ref.probe_colsum_ref(*args, lq=lq), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, pf_kernel.probe_colsum(*args, lq=lq))


@pytest.mark.parametrize("hk,d", [(4, 128), (5, 64)], ids=["qwen2", "smollm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cst_quant_at_4_and_5_kv_heads(dev, hk, d, dtype):
    """Both stores of one prefill at qwen2's 4 and smollm's 5 kv heads, one
    launch each, bitwise the plain version."""
    gen = torch.Generator(device=dev).manual_seed(80 + hk)
    ccfg = CompressionConfig.zipcache()
    b, l = 4, 300
    k, v = (_randn(gen, b, hk, l, d, dtype=dtype) for _ in range(2))
    s_hi, s_lo, _ = kvc.capacities(ccfg, l + 64)
    sal_idx, reg_idx = sal.salient_split(torch.rand((b, l), generator=gen, device=dev),
                                         ccfg.n_salient(l))
    for bits, cap, idx in ((ccfg.high_bits, s_hi, sal_idx), (ccfg.low_bits, s_lo, reg_idx)):
        idx = torch.nn.functional.pad(idx, (0, cap - idx.shape[1]), value=-1)
        before = cst_kernel.KERNEL.launches
        got = cst_kernel.quantize_store(k, v, idx, bits)
        assert cst_kernel.KERNEL.launches == before + 1
        for a, w in zip(got, cst_ref.quantize_store_ref(k, v, idx, bits)):
            assert a.dtype == w.dtype and torch.equal(a, w)


def _new_smoke(dev, which):
    """qwen2 smoke at 7 / 1 heads, head dim 16 (g = 7), with random QKV
    biases; smollm smoke at 3 / 1 heads of head dim 16 (g = 3; its own head
    dim, 20, is in no kernel's HEAD_DIMS), tied embeddings."""
    if which == "qwen2-g7":
        cfg = dataclasses.replace(configs.get_arch("qwen2-7b", smoke=True), n_heads=7,
                                  n_kv_heads=1, d_model=112)
    else:
        cfg = dataclasses.replace(configs.get_arch("smollm-360m", smoke=True), head_dim=16)
    params = registry.materialize_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    for sub in params["groups"].values():
        for name in ("bq", "bk", "bv"):
            if name in sub["attn"]:
                leaf = sub["attn"][name]
                leaf.copy_(_randn(gen, *leaf.shape, dtype=leaf.dtype, dev=dev, scale=0.5))
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    return cfg, ccfg, params


@pytest.mark.parametrize("which", ["qwen2-g7", "smollm-g3"])
def test_new_group_sizes_captured_steps_match_eager(dev, which):
    """Both engines on a g = 7 (QKV bias) and a g = 3 (tied embeddings)
    smoke model: the lockstep step (mixed, decode_qattn) and the continuous
    step (paged free list, paged_qattn) captured against capture=False
    through probe steps, folds, admissions and retirements: every step's
    logits bitwise the eager step's, tokens equal; the non-probe lockstep
    steps and every continuous step through the walk, none on the plain or
    the gather route."""
    cfg, ccfg, params = _new_smoke(dev, which)
    assert cfg.n_heads // cfg.n_kv_heads == (7 if which == "qwen2-g7" else 3)
    rng = np.random.default_rng(4)
    batch = pack_requests([rng.integers(2, cfg.vocab, size=n) for n in (48, 20)], 2, 48)
    prompts = [rng.integers(2, cfg.vocab, size=(n,)).astype(np.int32) for n in (40, 24, 33)]
    layout = dict(backend="paged", page_size=8, page_allocator="freelist", paged_kernel=True)
    max_new = 12
    n_probe = sum(probe_flag(i, ccfg.recompress_interval, 0) for i in range(max_new))
    runs = []
    for capture in (True, False):
        dq_kernel.KERNEL.launches = pq_kernel.KERNEL.launches = 0
        backend_lib.PLAIN_DECODES.launches = paged.GATHER_DECODES.launches = 0
        lock = ServingEngine(cfg, ccfg, ServeConfig(2, 48, max_new), params, device=dev,
                             capture=capture)
        lock_rec = lock._decode = _Recorded(lock._decode)
        toks = lock.generate({"tokens": batch})["tokens"].tolist()
        torch.cuda.synchronize()
        lock_counts = (dq_kernel.KERNEL.launches, backend_lib.PLAIN_DECODES.launches)
        cont = ContinuousEngine(cfg, ccfg, ServeConfig(2, 48, max_new, **layout), params,
                                device=dev, capture=capture)
        cont_rec = cont._decode_masked = _ActiveLogits(cont._decode_masked)
        rids = [cont.submit(Request(tokens=p, max_new_tokens=m))
                for p, m in zip(prompts, (12, 4, 12))]
        res = cont.run()
        torch.cuda.synchronize()
        assert paged.GATHER_DECODES.launches == 0
        assert pq_kernel.KERNEL.launches == cfg.n_layers * cont._step_no
        runs.append((toks, [res[r].tokens.tolist() for r in rids], lock_rec, cont_rec,
                     lock_counts))
    (toks, ctoks, lock_cap, cont_cap, counts), (want, cwant, lock_eag, cont_eag, e_counts) = runs
    assert toks == want and ctoks == cwant
    assert counts == e_counts == (cfg.n_layers * (max_new - n_probe), cfg.n_layers * n_probe)
    for cap, eag in ((lock_cap, lock_eag), (cont_cap, cont_eag)):
        assert cap.step.captures == 1 and cap.step.replays > 0
        assert len(cap.logits) == len(eag.logits)
        for a, w in zip(cap.logits, eag.logits):
            assert torch.equal(a, w)


# ---------------------------------------------------------------------------
# Training on the card (slice 16): no kernel of the port runs on this path
# ---------------------------------------------------------------------------

def _train_setup(dev, seq=128, batch=4):
    from repro_torch.data import DataConfig, TokenPipeline

    cfg = configs.get_arch("smollm-360m", smoke=True)
    params = registry.materialize_params(cfg, seed=0, device=dev)
    pipe = TokenPipeline(DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab, seed=3))
    host = next(pipe)
    pipe.close()
    return cfg, params, host


def test_train_step_on_card_matches_cpu(dev):
    """One microbatch on the card against the port on the CPU, at
    `chip_smoke.py` phase 4n (iii)'s tolerances: the loss at the
    reference's init within 1e-3 relative; the loss again, the gradient
    norm (1e-2) and each gradient leaf (2e-2 relative L2) at
    `common.fan_in_init` of the same draws.  At the reference's init the
    bf16 gradients are rounding noise (0.52 relative L2 from a float64 run
    on smollm's smoke config, tests/test_torch_train_loss.py), which two
    devices round apart; at the fan-in init they are not.  Readings
    (NVIDIA H100 80GB HBM3, 700.00 W): the reference init's loss 2.38e-5
    relative; at the fan-in init the loss 1.05e-6, the norm 1.86e-4, the
    worst leaf (layer 0's wq) 4.82e-3."""
    from repro_torch import tree
    from repro_torch.launch import train
    from repro_torch.optim import global_norm

    cfg, params, host = _train_setup(dev)
    ctx = blocks.RunCtx(q_block=64)
    on = {d: train.to_device(host, d) for d in (dev, "cpu")}

    def step(p, d):
        return steps_lib.loss_and_grads(tree.tree_map(lambda t: t.to(d), p), on[d], cfg, ctx)

    def rel(a, b):
        return abs(a - b) / abs(b)

    ref_rel = rel(step(params, dev)[0].item(), step(params, "cpu")[0].item())
    fan = common.fan_in_init(params)
    (loss_c, _, g_c), (loss_h, _, g_h) = step(fan, dev), step(fan, "cpu")
    loss_rel = rel(loss_c.item(), loss_h.item())
    norm_rel = rel(global_norm(g_c).item(), global_norm(g_h).item())
    leaf_rel = {}
    for (name, _), a, b in zip(tree.named_leaves(params), g_c, g_h):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        leaf_rel[name] = ((a.cpu().float() - b.float()).norm() / b.float().norm()).item()
    worst = max(leaf_rel, key=leaf_rel.get)
    print(f"reference init: loss {ref_rel:.2e}; fan-in init: loss {loss_rel:.2e}, norm "
          f"{norm_rel:.2e}, worst leaf {worst} {leaf_rel[worst]:.2e}")
    assert ref_rel <= 1e-3 and loss_rel <= 1e-3 and norm_rel <= 1e-2
    assert leaf_rel[worst] <= 2e-2, (worst, leaf_rel[worst])


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_twice_is_bitwise(dev, grad_accum):
    """The same step from one state twice: bitwise equal parameters,
    optimizer state and metrics (the tied embedding's gradient meets two
    contributions; Zipf tokens repeat ids in the embedding's backward)."""
    from repro_torch import tree
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg, params, host = _train_setup(dev)
    step = steps_lib.make_train_step(cfg, AdamWConfig(lr=1e-3), grad_accum=grad_accum,
                                     q_block=64)
    state = (params, adamw_init(params))
    # a step updates its state in place: each run starts from a copy
    runs = [step(*tree.tree_map(torch.clone, state), train.to_device(host, dev))
            for _ in range(2)]
    for a, b in zip(tree.leaves(runs[0]), tree.leaves(runs[1])):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_blocking_checkpoint_streams_device_tensors(dev, tmp_path):
    """A blocking save writes each device leaf through one pinned buffer (no
    host copy of the tree): the checkpoint restores bitwise, bf16 and f32
    leaves of several sizes, the largest first."""
    from repro_torch import tree
    from repro_torch.checkpoint import Checkpointer

    gen = torch.Generator(device=dev).manual_seed(4)
    state = {"big": torch.randn(3, 1000, 700, generator=gen, device=dev),
             "small": [torch.randn(77, generator=gen, device=dev).to(torch.bfloat16),
                       torch.arange(5, device=dev, dtype=torch.int32)]}
    ck = Checkpointer(tmp_path)
    ck.save(2, state, {"step": 2}, blocking=True)
    restored, meta = ck.restore(2, tree.tree_map(torch.empty_like, state))
    assert meta == {"step": 2}
    for a, b in zip(tree.leaves(state), tree.leaves(restored)):
        assert b.device == a.device and b.dtype == a.dtype and torch.equal(a, b)


def test_checkpoint_of_device_tensors_round_trips(dev, tmp_path):
    from repro_torch import tree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim import adamw_init

    _, params, _ = _train_setup(dev)
    state = (params, adamw_init(params))
    ck = Checkpointer(tmp_path)
    ck.save(5, state, {"step": 5})
    ck.wait()
    restored, meta = ck.restore(5, tree.tree_map(torch.empty_like, state))
    assert meta == {"step": 5}
    for a, b in zip(tree.leaves(state), tree.leaves(restored)):
        assert b.device == a.device and b.dtype == a.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Training of the other families on the card (slice 17): no kernel runs
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("deepseek-v2-lite-16b", "deepseek-moe-16b", "mamba2-2.7b", "jamba-v0.1-52b",
                "seamless-m4t-medium", "llava-next-34b")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_twice_is_bitwise(dev, arch):
    """The same step of each family's smoke config from one state twice, two
    microbatches: bitwise equal parameters, optimizer state and metrics.
    The MoE dispatch's backward, the SSD's chunk scan and the
    encoder-decoder's f32 encoder run under autograd on the card with no
    atomics."""
    from repro_torch import tree
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = configs.get_arch(arch, smoke=True)
    pipe = TokenPipeline(train.data_config(cfg, 128, 4, seed=3))
    host = next(pipe)
    pipe.close()
    params = registry.materialize_params(cfg, seed=0, device=dev)
    step = steps_lib.make_train_step(cfg, AdamWConfig(lr=1e-3), grad_accum=2, q_block=64)
    state = (params, adamw_init(params))
    # a step updates its state in place: each run starts from a copy
    runs = [step(*tree.tree_map(torch.clone, state), train.to_device(host, dev))
            for _ in range(2)]
    assert np.isfinite(runs[0][2]["loss"].item())
    for a, b in zip(tree.leaves(runs[0]), tree.leaves(runs[1])):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_moe_dispatch_backward_is_the_f32_sum(dev):
    """`common.gather_rows` at DeepSeek-V2-Lite's dispatch (1024 tokens, top
    6 of 64 experts, d_model 2048, its capacity): the gradient of the
    tokens' rows into the expert slots is each token's contributions summed
    in f32 and rounded once, bitwise the CPU's ordered sum, and the same on
    a second call."""
    cfg = configs.get_arch("deepseek-v2-lite-16b")
    n, k, e = 1024, cfg.top_k, cfg.d_model
    gen = torch.Generator(device="cpu").manual_seed(7)
    eidx = torch.rand(n, cfg.n_experts, generator=gen).argsort(-1)[:, :k]
    from repro_torch.models import mlp

    cap = mlp.capacity(cfg, n)
    flat = eidx.reshape(-1)
    sort_idx = torch.sort(flat, stable=True).indices
    starts = torch.searchsorted(flat[sort_idx], torch.arange(cfg.n_experts))
    src = (starts[:, None] + torch.arange(cap)[None, :]).clamp_max(n * k - 1)
    idx = (sort_idx // k)[src]                                    # (E, C) token of each slot
    x = torch.randn(n, e, generator=gen).to(torch.bfloat16)
    ct = torch.randn(*idx.shape, e, generator=gen).to(torch.bfloat16)
    grads = []
    for _ in range(2):
        xd = x.to(dev).requires_grad_(True)
        (g,) = torch.autograd.grad(common.gather_rows(xd, idx.to(dev)), xd, ct.to(dev))
        grads.append(g.cpu())
    want = torch.zeros(n, e).index_add_(0, idx.reshape(-1), ct.float().reshape(-1, e))
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(grads[0], want.to(torch.bfloat16))


@pytest.mark.parametrize("kind", ["mla", "ssm"])
def test_mla_and_ssd_grads_on_card_match_cpu(dev, kind):
    """The VJP of `mla_forward` (DeepSeek-V2-Lite's smoke prefix layer) and of
    `ssm_forward` (mamba2's smoke layer 0) on the card against the CPU, at a
    fan-in init of the same draws, a seeded input and cotangent: the output
    and each gradient of a parameter or the input within 2e-2 relative L2
    (`chip_smoke.py` phase 4o (iii)'s leaf tolerance)."""
    from repro_torch import tree
    from repro_torch.models import ssm

    arch = "deepseek-v2-lite-16b" if kind == "mla" else "mamba2-2.7b"
    cfg = configs.get_arch(arch, smoke=True)
    full = common.fan_in_init(registry.materialize_params(cfg, seed=1, device="cpu"))
    params = (full["prefix"]["layer0"]["attn"] if kind == "mla"
              else common.layer_slice(full["groups"]["sub0"]["ssm"], 0))
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 128, cfg.d_model, generator=gen).to(torch.bfloat16)
    ct = torch.randn(2, 128, cfg.d_model, generator=gen).to(torch.bfloat16)

    def vjp(d):
        leaves = [t.to(d).requires_grad_(True) for t in tree.leaves(params)]
        xd = x.to(d).requires_grad_(True)
        p = tree.unflatten(params, leaves)
        y = (attention.mla_forward(p, xd, cfg, q_block=64)[0] if kind == "mla"
             else ssm.ssm_forward(p, xd, cfg)[0])
        return [y] + list(torch.autograd.grad(y, leaves + [xd], ct.to(d)))

    worst = 0.0
    for a, b in zip(vjp(dev), vjp("cpu")):
        rel = ((a.cpu().float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        assert a.dtype == b.dtype and rel <= 2e-2, rel
    print(f"{kind}: worst relative L2 {worst:.2e}")


# ---------------------------------------------------------------------------
# The pipeline on one stage (slice 21): no kernel runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,axes", [("yi-6b", ("stage",)),
                                       ("smollm-360m", ("stage", "data", "model"))])
def test_one_stage_pipeline_matches_plain_step(dev, arch, axes):
    """`make_pp_train_step` on a one-stage mesh over NCCL (a world of one
    process) against the plain step on the card: the smoke config at
    `common.fan_in_init` of its seed-0 draws, 3 steps of the pipeline's 8 x
    32 batches, 4 microbatches, AdamW at lr 1e-3; `pp_forward`'s logits of
    the first batch against `lm.forward`'s.  Within
    tests/test_torch_mesh_step.py's bf16 bounds: the metrics 2e-3 relative,
    parameters and master 1.5e-2 relative L2 per leaf, m and v 2.5e-2; the
    logits within one bf16 ulp of the largest.  smollm ties its
    embeddings: the lookup's and the unembedding's gradients meet in one
    leaf."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import pipeline as pp
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = configs.get_arch(arch, smoke=True)
    params = common.fan_in_init(registry.materialize_params(cfg, 0, device=dev))
    pipe = TokenPipeline(train.data_config(cfg, 32, 8, 0))
    batches = [train.to_device(next(pipe), dev) for _ in range(3)]
    pipe.close()
    try:
        mesh = mesh_lib.make_mesh((1,) * len(axes), axes)
        assert dist.get_backend() == "nccl"
        with torch.no_grad():
            got = pp.pp_forward(params, batches[0]["tokens"], cfg, mesh, 4)
            want = lm.forward(params, batches[0]["tokens"], cfg, blocks.RunCtx(q_block=64),
                              remat=False).logits
        runs = []
        for step, state in (
                (steps_lib.make_train_step(cfg, AdamWConfig(lr=1e-3), q_block=64),
                 (tree.tree_map(torch.clone, params), adamw_init(params))),
                (pp.make_pp_train_step(cfg, mesh, 4, AdamWConfig(lr=1e-3), q_block=64),
                 steps_lib.shard_train_state(params, cfg, mesh, pp.PP_OVERRIDES))):
            mets = []
            for bt in batches:
                *state, met = step(*state, bt)
                mets.append({k: met[k].item() for k in ("loss", "grad_norm", "lr")})
            runs.append((mets, state))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    logits = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    (p_mets, p_state), (q_mets, q_state) = runs
    metric = max(abs(q[k] - p[k]) / abs(p[k]) for p, q in zip(p_mets, q_mets) for k in p)
    worst = {}
    for (name, a), b in zip(tree.named_leaves(p_state), tree.leaves(q_state)):
        if a.is_floating_point():
            rel = ((b.float() - a.float()).norm() / a.float().norm().clamp_min(1e-30)).item()
            tol = 2.5e-2 if name.split("/")[1] in ("m", "v") else 1.5e-2
            assert b.device.type == "cuda" and rel <= tol, (name, rel)
            worst[name] = rel
    name = max(worst, key=worst.get)
    print(f"{arch} {axes}: logits {logits:.3g} of the largest; metrics {metric:.3g}; "
          f"worst leaf {name} {worst[name]:.3g}")
    assert logits <= 2 ** -8 and metric <= 2e-3
