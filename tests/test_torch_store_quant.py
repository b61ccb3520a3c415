"""Port parity: the cache stores through the `cst_quant` kernel's route, and
the attention-output projection without a copy of `wo`.

The kernel route of a store (`kvcache.store_at` with `use_kernel`) takes,
on the CPU, the kernel's plain version `cst_quant/ref.quantize_store_ref`;
it is held against the JAX package's quantizers on the gathered block and
against the cache's plain route, bit for bit (tolerance: exact), as are
the reference oracles `cst_quantize_ref` / `cst_dequantize_ref`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import kvcache as jkvc
from repro.core import quant as jquant
from repro.kernels.cst_quant import ref as jcst_ref
from repro_torch import configs
from repro_torch.core import kvcache as kvc
from repro_torch.core import paged
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels.cst_quant import kernel as cst_kernel
from repro_torch.kernels.cst_quant import ref as cst_ref
from repro_torch.models import registry
from repro_torch.serving import ServeConfig, ServingEngine
from tests.test_torch_kvcache import _assert_cache_equal, _cfgs
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
STORE_FIELDS = ("k_codes", "k_scale", "k_zero", "v_codes", "v_scale", "v_zero", "v_cscale")


def _jx(rng, shape, dtype, scale=1.0):
    return jnp.asarray(rng.normal(size=shape).astype(np.float32) * scale).astype(dtype)


@pytest.fixture
def route_calls(monkeypatch):
    """Counts the kernel route's calls on the CPU (its plain version)."""
    calls = []
    plain = cst_ref.quantize_store_ref

    def spy(*args):
        calls.append(args[3])
        return plain(*args)

    monkeypatch.setattr(cst_kernel.ref, "quantize_store_ref", spy)
    return calls


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_store_ref_matches_reference(bits, dtype, rng):
    """One store: row 0 reads 36 shuffled tokens, row 1 30 and a -1 tail
    (zero rows).  K channel 3 is 0.75 on every token, so row 0's K scale of
    that channel clamps to eps; V channel 5 is 0, so c clamps to sqrt(eps);
    the zero rows' V token scales clamp to eps."""
    b, hk, l, d, s = 2, 2, 40, 32, 36
    k = np.array(_jx(rng, (b, hk, l, d), dtype, 2.0).astype(jnp.float32))
    v = np.array(_jx(rng, (b, hk, l, d), dtype).astype(jnp.float32))
    k[..., 3] = 0.75
    v[..., 5] = 0.0
    kj, vj = jnp.asarray(k).astype(dtype), jnp.asarray(v).astype(dtype)
    idx = np.full((b, s), -1, np.int32)
    idx[0] = rng.permutation(l)[:s]
    idx[1, :30] = rng.permutation(l)[:30]

    def gather(x):
        rows = jnp.take_along_axis(x, jnp.asarray(np.maximum(idx, 0))[:, None, :, None], axis=2)
        return jnp.where(jnp.asarray(idx >= 0)[:, None, :, None], rows, jnp.zeros((), x.dtype))

    wk = jquant.quantize_channelwise(gather(kj), bits)
    wv = jquant.quantize_cst(gather(vj), bits)
    want = (wk.codes, wk.scale, wk.zero, wv.codes, wv.scale, wv.zero, wv.channel_scale)
    launches = cst_kernel.KERNEL.launches
    for got in (cst_ref.quantize_store_ref(to_torch(kj), to_torch(vj), torch.from_numpy(idx),
                                           bits),
                cst_kernel.quantize_store(to_torch(kj), to_torch(vj), torch.from_numpy(idx),
                                          bits)):
        for name, a, w in zip(STORE_FIELDS, got, want):
            assert a.dtype == to_torch(w).dtype, name
            np.testing.assert_array_equal(to_np(a), to_np(w), err_msg=name)
    assert cst_kernel.KERNEL.launches == launches  # CPU tensors never launch
    assert float(to_np(want[1])[0, :, 0, 3].max()) == pytest.approx(1e-8, rel=1e-2)  # eps
    assert np.all(to_np(want[5])[1, :, 30:] == 0) and np.all(to_np(want[4])[1, :, 30:] > 0)


def _jcompress(jcfg, rng, dtype, b=2, hk=2, l=40, d=16, max_len=60):
    k, v = _jx(rng, (b, hk, l, d), dtype), _jx(rng, (b, hk, l, d), dtype)
    sal = rng.uniform(size=(b, l)).astype(np.float32)
    sal[:, -6:] = 0.0
    nnz = rng.integers(1, 5, size=(b, l)).astype(np.float32)
    want = jkvc.compress_prefill(jcfg, k, v, jnp.asarray(sal), max_len,
                                 probe_nnz=jnp.asarray(nnz), dtype=dtype)
    args = (to_torch(k), to_torch(v), torch.from_numpy(sal), max_len)
    return want, args, dict(probe_nnz=torch.from_numpy(nnz), dtype=to_torch(k).dtype)


def _assert_same(a, b):
    for x, y in zip(kvc.tree_leaves(a), kvc.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_compress_prefill_kernel_route_matches(dtype, rng, route_calls):
    """compress_prefill with use_kernel (one store call per store, hi and
    lo, padded with -1 to capacity) equals the plain route and the JAX
    package's compress_prefill."""
    jcfg, cfg = _cfgs()
    want, args, kw = _jcompress(jcfg, rng, dtype)
    got = kvc.compress_prefill(cfg, *args, use_kernel=True, **kw)
    assert route_calls == [cfg.high_bits, cfg.low_bits]
    _assert_same(got, kvc.compress_prefill(cfg, *args, use_kernel=False, **kw))
    _assert_cache_equal(got, want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("rows", [None, [True, False]], ids=["all-rows", "row-0"])
def test_recompress_kernel_route_matches(dtype, rows, rng, route_calls):
    """recompress with use_kernel (invalid slots read zero rows through -1
    slot indices) after appends and a probe step equals the plain route and
    the JAX package's recompress."""
    jcfg, cfg = _cfgs()
    want, args, kw = _jcompress(jcfg, rng, dtype)
    got = kvc.compress_prefill(cfg, *args, **kw)
    b, hk, _, d = args[0].shape
    for step in range(6):
        kt, vt = _jx(rng, (b, hk, d), dtype), _jx(rng, (b, hk, d), dtype)
        want = jkvc.append_token(want, kt, vt)
        got = kvc.append_token(got, to_torch(kt), to_torch(vt))
        if step == 3:
            w = rng.uniform(size=(b, want.capacity)).astype(np.float32)
            want = jkvc.update_probe_state(want, jnp.asarray(w), jnp.asarray(True))
            got = kvc.update_probe_state(got, torch.from_numpy(w), True)
    jrows = None if rows is None else jnp.asarray(rows)
    trows = None if rows is None else torch.tensor(rows)
    new = kvc.recompress(cfg, got, rows=trows, use_kernel=True)
    assert route_calls == [cfg.high_bits, cfg.low_bits]
    _assert_same(new, kvc.recompress(cfg, got, rows=trows, use_kernel=False))
    _assert_cache_equal(new, jkvc.recompress(jcfg, want, rows=jrows))


def test_paged_recompress_slot_kernel_route_matches(rng, route_calls):
    """The paged layout inherits the route: recompress_slot with use_kernel
    equals the plain route bit for bit."""
    _, cfg = _cfgs()
    _, args, kw = _jcompress(_cfgs()[0], rng, jnp.bfloat16)
    mx = kvc.compress_prefill(cfg, *args, **kw)
    b, hk, _, d = args[0].shape
    for _ in range(5):
        kt = to_torch(_jx(rng, (b, hk, d), jnp.bfloat16))
        mx = kvc.append_token(mx, kt, kt)
    # the fold writes the page pools in place: each route folds its own copy
    got = paged.recompress_slot(cfg, paged.from_mixed(mx, page_size=8), 1, use_kernel=True)
    assert route_calls == [cfg.high_bits, cfg.low_bits]
    want = paged.recompress_slot(cfg, paged.from_mixed(mx, page_size=8), 1)
    _assert_same(got.dense_view(), want.dense_view())


@pytest.mark.parametrize("given_c", [False, True], ids=["c-computed", "c-given"])
@pytest.mark.parametrize("bits", [2, 4])
def test_cst_quantize_ref_matches_reference(bits, given_c, rng):
    x = _jx(rng, (48, 64), jnp.float32, 2.0)
    c = jnp.asarray(rng.uniform(0.5, 2.0, size=(1, 64)).astype(np.float32)) if given_c else None
    want = jcst_ref.cst_quantize_ref(x, bits, c)
    got = cst_ref.cst_quantize_ref(to_torch(x), bits, None if c is None else to_torch(c))
    for a, w in zip(got, want):
        assert a.dtype == to_torch(w).dtype and a.shape == tuple(w.shape)
        np.testing.assert_array_equal(to_np(a), to_np(w))


@pytest.mark.parametrize("out_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("bits", [2, 4])
def test_cst_dequantize_ref_matches_reference(bits, out_dtype, rng):
    x = _jx(rng, (48, 64), jnp.float32, 2.0)
    codes, scale, zero, c = jcst_ref.cst_quantize_ref(x, bits)
    want = jcst_ref.cst_dequantize_ref(codes, scale, zero, c, bits, out_dtype=out_dtype)
    got = cst_ref.cst_dequantize_ref(*(to_torch(t) for t in (codes, scale, zero, c)), bits,
                                     out_dtype={jnp.float32: torch.float32,
                                                jnp.bfloat16: torch.bfloat16}[out_dtype])
    assert got.dtype == to_torch(want).dtype
    np.testing.assert_array_equal(to_np(got), to_np(want))


def _f32(tree):
    return {k: _f32(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.float()


@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_out_proj_copies_no_weight(where):
    """The model's attention-output projection contracts over the flattened
    (h * d) axis through a view of `wo`: a record_shapes profile of an f32
    prefill and decode step (no CPU bf16 upcast) shows no copy or clone of
    a tensor with wo's element count (torch.einsum permuted and copied it)."""
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = _f32(registry.materialize_params(cfg, seed=0, device="cpu"))
    ctx = ServingEngine(cfg, ccfg, ServeConfig(2, 16, 4), params, device="cpu").ctx
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab, (2, 16))).int()
    n_wo = params["groups"]["sub0"]["attn"]["wo"][0].numel()
    logits, caches = registry.prefill(params, {"tokens": tokens}, cfg, ctx)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        if where == "prefill":
            registry.prefill(params, {"tokens": tokens}, cfg, ctx)
        else:
            registry.decode_step(params, logits.argmax(-1).int(), caches, cfg, ctx, False)
    copies = [(e.name, e.input_shapes[0]) for e in prof.events()
              if e.name in ("aten::clone", "aten::copy_") and e.input_shapes
              and e.input_shapes[0] and int(np.prod(e.input_shapes[0])) == n_wo]
    assert not copies, copies
