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
from repro_torch.core import kvcache as kvc
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels import build
from repro_torch.kernels.cst_quant import kernel as cst_kernel
from repro_torch.kernels.cst_quant import ref as cst_ref
from repro_torch.kernels.decode_qattn import kernel as dq_kernel
from repro_torch.kernels.decode_qattn import ref as dq_ref
from repro_torch.kernels.probe_flash import kernel as pf_kernel
from repro_torch.kernels.probe_flash import ops as pf_ops
from repro_torch.kernels.probe_flash import ref as pf_ref
from repro_torch.models import registry
from repro_torch.serving import ServeConfig, ServingEngine, pack_requests

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
