"""Port parity for the mixed-cache decode layer (`decode_qattn`'s
`qattn_mixed_layer`, one launch per decode layer on the card) on the CPU,
where the wrapper runs its plain version `ref.mixed_layer_ref`.

The same caches, made from one numpy seed, go through the JAX package's
`kvcache.attend_decode` (the exact live path, which rounds dequantized K/V
to the store dtype, as the port does) and its Pallas `decode_attend_mixed`
in interpret mode (which does not round).  Tolerances, as
`tests/test_torch_kernels.py::test_decode_qattn_plain_version_matches_reference`:
float32 scores and softmax summed in another order, 1e-5 absolute; bf16
outputs within one bf16 ulp of the exact path (2^-7 absolute and relative)
and within the store rounding of the Pallas path (5e-2 absolute).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as jkvc
from repro.core.policy import CompressionConfig as JCompression
from repro.kernels.decode_qattn import ops as jdq_ops
from repro_torch.core import kvcache as kvc
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels import qattn_walk as walk
from repro_torch.kernels.decode_qattn import kernel as dq_kernel
from repro_torch.kernels.decode_qattn import ops as dq_ops
from repro_torch.kernels.decode_qattn import ref as dq_ref
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
TOL = 1e-5
WINDOW = 8  # max(recompress_interval, 8) slots at these sizes


def _caches(rng, dtype, n_append, high_bits=4, b=2, hk=2, l=40, d=16, max_len=60):
    """The same mixed cache built by both packages: prefill + appends."""
    kw = dict(high_bits=high_bits, fp_window=8, recompress_interval=8)
    jcfg = dataclasses.replace(JCompression.zipcache(), **kw)
    cfg = dataclasses.replace(CompressionConfig.zipcache(), **kw)
    f = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32)).astype(dtype)  # noqa: E731
    k, v = f(b, hk, l, d), f(b, hk, l, d)
    s = jnp.asarray(rng.uniform(size=(b, l)).astype(np.float32))
    jc = jkvc.compress_prefill(jcfg, k, v, s, max_len, dtype=dtype)
    tc = kvc.compress_prefill(cfg, to_torch(k), to_torch(v), to_torch(s), max_len,
                              dtype=to_torch(k).dtype)
    for _ in range(n_append):
        kt, vt = f(b, hk, d), f(b, hk, d)
        jc = jkvc.append_token(jc, kt, vt)
        tc = kvc.append_token(tc, to_torch(kt), to_torch(vt))
    return jc, tc, f(b, 4 * hk, d)


def _held(dtype, jc, tc, q, bits):
    """The layer's plain version and `decode_attend_mixed` on the CPU against
    the exact path and the Pallas path."""
    segs = dq_ops.mixed_segments(tc)
    assert [(s["k_bits"], s["v_bits"]) for s in segs] == bits
    launches = dq_kernel.KERNEL.launches
    tq = to_torch(q)
    got = dq_ref.mixed_layer_ref(tq, segs)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert torch.equal(dq_ops.decode_attend_mixed(tq, tc), got)
    assert torch.equal(dq_kernel.qattn_mixed_layer(tq, segs), got)
    assert dq_kernel.KERNEL.launches == launches  # CPU tensors never launch
    got = to_np(got)
    exact = to_np(jkvc.attend_decode(q, jc).out)
    pallas = to_np(jdq_ops.decode_attend_mixed(q, jc, block_s=16, interpret=True))
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, exact, atol=TOL)
        np.testing.assert_allclose(got, pallas, atol=TOL)
    else:
        np.testing.assert_allclose(got, exact, atol=2 ** -7, rtol=2 ** -7)
        np.testing.assert_allclose(got, pallas, atol=5e-2)


@pytest.mark.parametrize("n_append", [0, 5, WINDOW], ids=["window-empty", "window-partial",
                                                          "window-full"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_mixed_layer_matches_reference(dtype, n_append, rng):
    """4-bit hi, 2-bit lo and the raw window in one layer call; the window
    has no valid slot, some, or every slot filled."""
    jc, tc, q = _caches(rng, dtype, n_append)
    assert int(tc.win_fill.max()) == n_append and tc.window == WINDOW
    _held(dtype, jc, tc, q, [(4, 4), (2, 2), (16, 16)])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_mixed_layer_raw_store_matches_reference(dtype, rng):
    """ZipCache's schemes with a raw 16-bit hi store: the hi segment takes the
    raw instantiation (values pass through, no parameters)."""
    jc, tc, q = _caches(rng, dtype, 3, high_bits=16)
    segs = dq_ops.mixed_segments(tc)
    assert segs[0]["k_codes"].dtype == to_torch(q).dtype and "k_scale" not in segs[0]
    _held(dtype, jc, tc, q, [(16, 16), (2, 2), (16, 16)])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layer_descriptors(dtype, rng):
    """What the wrapper hands the kernel (checked on the CPU, where the
    tensors' addresses stand in for the card's): one descriptor per segment
    in walk order, contiguous addressing (no table), each segment's slot
    count its store's capacity, the parameters' dtype, and no parameters for
    the raw window."""
    _, tc, q = _caches(rng, dtype, 5)
    tq = to_torch(q)
    segs = dq_ops.mixed_segments(tc)
    descs = [dq_kernel._describe(tq, s)[0] for s in segs]
    assert [dd.s_seg for dd in descs] == [tc.hi.capacity, tc.lo.capacity, tc.window]
    assert [(dd.k_bits, dd.v_bits) for dd in descs] == [(4, 4), (2, 2), (16, 16)]
    assert all(dd.table is None and dd.npp == dd.page == 0 for dd in descs)
    assert {dd.t_bf16 for dd in descs} == {int(tq.dtype == torch.bfloat16)}
    assert all(dd.ks and dd.vts for dd in descs[:2])
    assert not any((descs[2].ks, descs[2].kz, descs[2].vcs, descs[2].vts, descs[2].vtz))
    n_blk = sum(-(-dd.s_seg // walk.SLOT_BLOCK) for dd in descs)
    assert n_blk == -(-tc.hi.capacity // 32) + -(-tc.lo.capacity // 32) + 1


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_mixed_layer_stats_merge_to_the_output(dtype, rng):
    """The layer's statistics output (`stats=True`, what a slot split over a
    mesh merges): acc / l is the normalized output bit for bit; (m, l) are
    the row's softmax max and sum over every segment (1e-5); each half of
    every segment's slots, merged in order, is the whole layer's output
    within 1e-5 (f32) or one bf16 ulp; none taken is an empty partial."""
    _, tc, q = _caches(rng, dtype, 5)
    tq = to_torch(q)
    segs = dq_ops.mixed_segments(tc)
    out = dq_kernel.qattn_mixed_layer(tq, segs)
    acc, m, l = dq_kernel.qattn_mixed_layer(tq, segs, stats=True)
    assert acc.dtype == m.dtype == l.dtype == torch.float32 and acc.shape == tq.shape
    assert torch.equal((acc / l.clamp_min(1e-30)[..., None]).to(tq.dtype), out)
    scale = 1.0 / (tq.shape[-1] ** 0.5)
    k, _, valid, _ = kvc.cache_keys_values(tc)
    b, hk = k.shape[:2]
    s = torch.einsum("bhgd,bhsd->bhgs", tq.reshape(b, hk, -1, tq.shape[-1]).float() * scale,
                     k.float()).masked_fill(~valid[:, None, None, :], dq_ref.NEG_INF)
    want_m = s.amax(-1).reshape(m.shape)
    np.testing.assert_allclose(to_np(m), to_np(want_m), atol=TOL)
    np.testing.assert_allclose(to_np(l), to_np(torch.exp(s - s.amax(-1, keepdim=True))
                                              .sum(-1).reshape(l.shape)), rtol=TOL)

    parts = [dq_kernel.qattn_mixed_layer(tq, [dq_ops.segment_share(o, 2, i, 2) for o in segs],
                                         stats=True) for i in range(2)]
    merged = dq_ref.merge_segments_ref(parts).to(tq.dtype)
    tol = TOL if dtype == jnp.float32 else 2 ** -7 * max(to_np(out).max(), 1.0)
    np.testing.assert_allclose(to_np(merged).astype(np.float32),
                               to_np(out).astype(np.float32), atol=tol)
    empty = dq_ops.decode_attend_mixed(tq, tc, stats=True, taken=(False, False, False))
    assert float(empty[0].abs().max()) == 0 and float(empty[2].max()) == 0
    assert torch.equal(dq_ops.decode_attend_mixed(tq, tc, stats=True, taken=(True,) * 3)[0], acc)


def test_split_plan():
    """The walk's split sizing, which every launch records on its kernel:
    every block in one split, no split empty, at most MAX_SPLITS; fp16's
    full-width raw layer (1152 + 100 slots, batch 4, 4 kv heads, 528 CTAs)
    walks 20 splits of 2 blocks."""
    segs = lambda *lens: [walk.SegDesc(s_seg=n) for n in lens]  # noqa: E731
    assert walk.split_plan(segs(1152, 100), 4, 4, 528) == (2, 20)
    # a share of a layer's kv heads (or rows) planned as the whole layer
    assert walk.split_plan(segs(1152, 100), 4, 2, 528, plan_bh=16) == (2, 20)
    assert walk.split_plan(segs(1152, 100), 4, 2, 528) != (2, 20)
    for lens, b, hk in [((461, 691, 100), 4, 4), ((64,), 1, 1), ((5, 33), 2, 1),
                        ((1 << 20,), 1, 1)]:
        bpc, nsplit = walk.split_plan(segs(*lens), b, hk, 528)
        n_blk = sum(-(-n // walk.SLOT_BLOCK) for n in lens)
        assert (nsplit - 1) * bpc < n_blk <= nsplit * bpc and nsplit <= walk.MAX_SPLITS


def test_layer_rejects_mismatched_operands(rng):
    """The wrapper's checks: a quantized store without its parameters, a pos
    of the wrong length, K raw and V quantized."""
    _, tc, q = _caches(rng, jnp.bfloat16, 2)
    tq = to_torch(q)
    hi, lo, win = dq_ops.mixed_segments(tc)
    for bad in (dict(lo, k_scale=None), dict(lo, pos=lo["pos"][:, :-1]),
                dict(win, v_bits=2), dict(hi, k_codes=hi["k_codes"][..., :-1])):
        with pytest.raises(ValueError):
            dq_kernel._describe(tq, bad)
