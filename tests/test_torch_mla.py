"""Port parity for MLA (DeepSeek-V2's latent attention) and the DeepSeek-V2-Lite
smoke model on the lockstep engine, against the JAX package.

  * `kvcache.attend_decode_mla_int8` on the same latent cache (the rope key
    channelwise as K, the latent CST as V): against the JAX function and
    against the exact softmax over the dequantized streams, within
    tests/test_kernels.py's tolerances (out atol 2e-2 rtol 1e-2, slot
    weights 1e-3);
  * `attention.mla_forward` (output, the rope-key and latent streams, the
    probe saliency) and `mla_decode` (`ref` and `int8_algebra`) on one
    layer of the smoke model's weights, f32 within 1e-4 and bf16 within one
    bf16 ulp of the largest value;
  * the smoke model (an MLA prefix layer with a dense FFN, then MLA + MoE
    layers) on the lockstep engine: greedy tokens equal the JAX engine's
    (jitted in a child process, `tests/serving_reference.py`, excess
    precision and the algebraic simplifier off: the op-by-op run's tokens)
    with fp_window 8 and recompress
    interval 8, across probe steps and a fold, on the kernel route (the
    main path's: `flash_fwd` / `probe_colsum` / `cst_quant`, their plain
    versions on the CPU); the prefill logits within one bf16 ulp of the
    largest on both routes.  The plain route's blocked attention sums in
    another order than XLA's and than `flash_fwd`'s plain version, and the
    router turns such a last-bit difference into another expert: on this
    batch row 1's logits differ by two bf16 ulps at decode step 2 and its
    tokens from step 3 on, so the plain route's tokens are not held.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import kvcache as jkvc
from repro.core import saliency as jsal
from repro.core.policy import CompressionConfig as JCompression
from repro.models import attention as jattn
from repro.models import registry as jregistry
from repro_torch import configs, convert
from repro_torch.core import kvcache as kvc
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.models import attention, registry
from repro_torch.serving import ServeConfig, ServingEngine, pack_requests
from tests import serving_reference as sr
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
ARCH = "deepseek-v2-lite-16b"
BATCH, PROMPT, MAX_NEW = sr.MLA_BATCH, sr.MLA_PROMPT, sr.MLA_NEW


def _ccfgs():
    kw = dict(fp_window=8, recompress_interval=8)
    return (dataclasses.replace(JCompression.zipcache(saliency_ratio=0.4), **kw),
            dataclasses.replace(CompressionConfig.zipcache(saliency_ratio=0.4), **kw))


def _close(got, want, dtype):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= 2 ** -8 * max(np.abs(want).max(), 1.0)


def _caches(rng, b=2, s=48, p=16, r=32):
    """The same compressed latent cache in both packages: rope key (b, 1, s,
    p), latent (b, 1, s, r), random saliency, f32 stores."""
    jcfg, tcfg = _ccfgs()
    kpe = rng.standard_normal((b, 1, s, p)).astype(np.float32)
    lat = rng.standard_normal((b, 1, s, r)).astype(np.float32)
    sc = rng.uniform(size=(b, s)).astype(np.float32)
    jc = jkvc.compress_prefill(jcfg, jnp.asarray(kpe), jnp.asarray(lat), jnp.asarray(sc),
                               max_len=s + 8, dtype=jnp.float32)
    tc = kvc.compress_prefill(tcfg, to_torch(kpe), to_torch(lat), to_torch(sc), max_len=s + 8,
                              dtype=torch.float32)
    return jc, tc


def test_attend_decode_mla_int8_matches_reference():
    rng = np.random.default_rng(0)
    jc, tc = _caches(rng)
    q_abs = rng.standard_normal((2, 4, 32)).astype(np.float32)
    q_pe = rng.standard_normal((2, 4, 16)).astype(np.float32)
    with jax.disable_jit():
        want_out, want_w = jkvc.attend_decode_mla_int8(jnp.asarray(q_abs), jnp.asarray(q_pe), jc,
                                                       scale=0.1)
    out, w = kvc.attend_decode_mla_int8(to_torch(q_abs), to_torch(q_pe), tc, scale=0.1)
    np.testing.assert_allclose(to_np(out), to_np(want_out), atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(to_np(w), to_np(want_w), atol=1e-3)
    # against the exact softmax over the port's own dequantized streams
    k_all, v_all, valid, _ = kvc.cache_keys_values(tc)
    k_all, v_all = k_all[:, 0], v_all[:, 0]
    logits = (torch.einsum("bhr,bsr->bhs", to_torch(q_abs), v_all)
              + torch.einsum("bhp,bsp->bhs", to_torch(q_pe), k_all)) * 0.1
    exact = torch.softmax(logits.masked_fill(~valid[:, None, :], -1e30), dim=-1)
    np.testing.assert_allclose(to_np(out), to_np(torch.einsum("bhs,bsr->bhr", exact, v_all)),
                               atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(to_np(w), to_np(exact.mean(dim=1)), atol=1e-3)


@pytest.fixture(scope="module")
def layer():
    """One MLA layer of the smoke model, in both packages, f32 and bf16."""
    cfg = jconfigs.get_arch(ARCH, smoke=True)
    with jax.threefry_partitionable(True):
        params = jregistry.materialize_params(cfg, seed=0)
    attn = jax.device_get(params["prefix"]["layer0"]["attn"])
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), attn)
        out[name] = (jp, jax.tree_util.tree_map(lambda a: to_torch(np.asarray(a)), jp), dt)
    return cfg, configs.get_arch(ARCH, smoke=True), out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_forward_matches_reference(layer, dtype):
    jcfg, tcfg, ps = layer
    jp, tp, jdt = ps[dtype]
    rng = np.random.default_rng(1)
    b, l = 2, 40
    x = jnp.asarray(rng.standard_normal((b, l, jcfg.d_model)), jdt)
    with jax.disable_jit():
        jprobe = jsal.select_probes(l, "random+recent", 0.2, 0)
        want_y, want = jattn.mla_forward(jp, x, jcfg, probe=jprobe, q_block=16)
    probe = sal.select_probes(l, "random+recent", 0.2, 0)
    np.testing.assert_array_equal(to_np(probe.positions), np.asarray(jprobe.positions))
    got_y, got = attention.mla_forward(tp, to_torch(np.asarray(x)), tcfg, probe=probe,
                                       q_block=16)
    assert got.k.shape == (b, 1, l, tcfg.rope_head_dim)
    assert got.v.shape == (b, 1, l, tcfg.kv_lora_rank)
    for a, w in ((got_y, want_y), (got.k, want.k), (got.v, want.v)):
        _close(a, w, dtype)
    np.testing.assert_allclose(to_np(got.saliency), to_np(want.saliency), atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(to_np(got.probe_nnz), to_np(want.probe_nnz))


@pytest.mark.parametrize("impl", ["ref", "int8_algebra"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_decode_matches_reference(layer, dtype, impl):
    """One decode token against a prefill cache of the layer's streams:
    (y, rope key, latent, slot weights) as the JAX function's."""
    jcfg, tcfg, ps = layer
    jp, tp, jdt = ps[dtype]
    jccfg, tccfg = _ccfgs()
    rng = np.random.default_rng(2)
    b, l = 2, 40
    x = jnp.asarray(rng.standard_normal((b, l, jcfg.d_model)), jdt)
    x_t = jnp.asarray(rng.standard_normal((b, jcfg.d_model)), jdt)
    sc = rng.uniform(size=(b, l)).astype(np.float32)
    with jax.disable_jit():
        _, aux = jattn.mla_forward(jp, x, jcfg, q_block=16)
        jc = jkvc.compress_prefill(jccfg, aux.k, aux.v, jnp.asarray(sc), max_len=l + 8,
                                   dtype=jdt)
        want = jattn.mla_decode(jp, x_t, jc, jcfg, jnp.full((b,), l, jnp.int32), impl=impl)
    _, taux = attention.mla_forward(tp, to_torch(np.asarray(x)), tcfg, q_block=16)
    tc = kvc.compress_prefill(tccfg, taux.k, taux.v, to_torch(sc), max_len=l + 8,
                              dtype=taux.k.dtype)
    pos = torch.full((b,), l, dtype=torch.int32)
    y, slot_w = attention.mla_decode(tp, to_torch(np.asarray(x_t)), tc, tcfg, pos, impl=impl)
    k_pe_t, latent_t = attention.mla_kv_t(tp, to_torch(np.asarray(x_t)), tcfg, pos)
    for a, w in zip((y, k_pe_t[:, None], latent_t[:, None]), want[:3]):
        _close(a, w, dtype)
    np.testing.assert_allclose(to_np(slot_w), to_np(want[3]), atol=1e-5)


# ---- the smoke model on the lockstep engine -----------------------------------

def _batch(vocab):
    return sr.mla_batch(vocab, pack_requests)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX engine's prefill logits and tokens, jitted in a child process
    (`tests/serving_reference.py`)."""
    return sr.run(tmp_path_factory.mktemp("mla_lockstep") / "ref.pkl", "mla_lockstep")


def _engine(reference, use_kernels):
    cfg = configs.get_arch(ARCH, smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(reference["params"], cfg, device="cpu")
    return ServingEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, MAX_NEW), params, device="cpu",
                         use_kernels=use_kernels)


def test_lockstep_tokens_match_reference(reference):
    got = _engine(reference, use_kernels=True).generate(reference["batch"])["tokens"]
    np.testing.assert_array_equal(got, reference["tokens"])


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel-route", "plain"])
def test_lockstep_prefill_logits_match_reference(reference, use_kernels):
    eng = _engine(reference, use_kernels=use_kernels)
    logits, caches = registry.prefill(
        eng.params, {"tokens": torch.as_tensor(reference["batch"]["tokens"])}, eng.cfg, eng.ctx)
    got, want = to_np(logits), reference["logits"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2 ** -8 * np.abs(want).max()
    # one prefix layer, then the groups; every layer an MLA cache of one head
    assert len(caches["prefix"]) == 1 and len(caches["groups"]) == eng.cfg.n_scan_groups
    for el in registry.cache_elements(caches):
        assert el.k_win.shape[1:] == (1, el.window, eng.cfg.rope_head_dim)
        assert el.v_win.shape[-1] == eng.cfg.kv_lora_rank
