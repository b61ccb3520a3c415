"""The remaining configs on the port: zipcache-paper-8b (LLaMA3-8B's shape),
deepseek-moe-16b (GQA + fine-grained MoE, a dense prefix layer),
qwen2-7b (g = 7, QKV bias), yi-34b (g = 7) and smollm-360m (g = 3, tied
embeddings), with a g = 7 variant of qwen2's smoke config (7 / 1 heads,
head dim 16: the smoke configs have g = 2, but for smollm's g = 3).

  * the registry: every reference arch resolves in the port, the full and
    smoke configs equal the reference's field for field, with its schema's
    shapes and its parameter count;
  * `convert.from_jax_params` carries each tree over leaf for leaf;
  * the prefill logits within one bf16 ulp of the largest (the existing
    tolerance of tests/test_torch_slice.py), on the kernel route and the
    plain route;
  * the lockstep engine's greedy tokens (fp_window 8, recompress interval 8:
    probe steps and a fold within 12 tokens) and the continuous engine's on
    the paged free list, equal to the JAX engines'; deepseek-moe-16b against
    the JAX continuous engine built with its MoE refusal hidden;
  * deepseek-moe-16b's prefill as DeepSeek-V2's is held: layer 0's
    attention output and the dense prefix layer's output (before any
    router) within one bf16 ulp of their largest, and the MoE layers, fed
    the reference's prefix output, giving its logits bit for bit.  At g = 1
    the blocked attention's f32 sums run in another order than XLA's, so 9
    of layer 0's 4096 bf16 outputs lie one ulp apart; through the routed
    layers the logits then differ by one ulp of the largest, and the
    lockstep tokens of row 0 take another token at step 10 (ROADMAP.md §3):
    the tokens are held through step 9, the continuous ones in full;
  * `cache_bytes` equal to the reference's integers;
  * qwen2's QKV biases, drawn at random on both sides, reach the prefill
    and the decode steps;
  * the serve CLI on each new arch.

The JAX engines run once, in two child processes (`tests/configs_reference.py`),
jitted with XLA's excess precision off.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.launch import serve
from repro_torch.models import attention, blocks, common, lm, registry
from repro_torch.serving import ContinuousEngine, Request, ServeConfig, ServingEngine
from tests import configs_reference as cr
from tests.configs_reference import ARCHS, BATCH, DSMOE, FREELIST, G7, MAX_NEW, PROMPT, QWEN
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
NEW = ("zipcache-paper-8b", "deepseek-moe-16b", "qwen2-7b", "yi-34b", "smollm-360m")


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return cr.run(tmp_path_factory.mktemp("configs") / "refs.pkl")


def _ccfg():
    return dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)


def _port(refs, arch):
    cfg = cr.smoke(configs, arch)
    return cfg, convert.from_jax_params(refs[arch]["params"], cfg, device="cpu")


# ---- the registry ---------------------------------------------------------------

def test_every_reference_arch_is_ported():
    assert set(configs._MODULES) == set(jconfigs._MODULES)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", NEW)
def test_config_schema_and_count_equal_the_reference(arch, smoke):
    cfg, want = configs.get_arch(arch, smoke), jconfigs.get_arch(arch, smoke)
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)} == \
        {f.name: getattr(want, f.name) for f in dataclasses.fields(cfg)}
    assert cfg.param_count() == want.param_count()
    got_s, want_s = registry.schema(cfg), jregistry.schema(want)
    flat_got = {jax.tree_util.keystr(p): tuple(d.shape) for p, d in
                jax.tree_util.tree_flatten_with_path(
                    got_s, is_leaf=lambda x: not isinstance(x, dict))[0]}
    flat_want = {jax.tree_util.keystr(p): tuple(d.shape) for p, d in
                 jax.tree_util.tree_flatten_with_path(
                     want_s, is_leaf=lambda x: not isinstance(x, dict))[0]}
    assert flat_got == flat_want


def test_full_configs_have_the_walks_group_sizes():
    """g = 7 (qwen2-7b, yi-34b, llava-next-34b), 3 (smollm-360m), 4
    (zipcache-paper-8b) and 1 (deepseek-moe-16b), every one in the walk's
    GROUPS; smollm ties its embeddings, qwen2 carries QKV biases."""
    from repro_torch.kernels import qattn_walk

    want = {"qwen2-7b": (7, 128), "yi-34b": (7, 128), "llava-next-34b": (7, 128),
            "smollm-360m": (3, 64), "zipcache-paper-8b": (4, 128), "deepseek-moe-16b": (1, 128)}
    for arch, (g, d) in want.items():
        cfg = configs.get_arch(arch)
        assert (cfg.n_heads // cfg.n_kv_heads, cfg.hd) == (g, d), arch
        assert g in qattn_walk.GROUPS and d in qattn_walk.HEAD_DIMS
    assert configs.get_arch("smollm-360m").tie_embeddings
    assert "lm_head" not in registry.schema(configs.get_arch("smollm-360m", smoke=True))
    assert configs.get_arch("qwen2-7b").qkv_bias


# ---- parameters ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_converts_each_tree(refs, arch):
    ref = refs[arch]["params"]
    cfg, got = _port(refs, arch)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat_ref) == len(jax.tree_util.tree_leaves(got))
    for path, want in flat_ref:
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_array_equal(to_np(leaf), to_np(want))
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(got)) >= cfg.param_count() > 0
    assert ("prefix" in got) == (arch == DSMOE)


# ---- the lockstep engine -----------------------------------------------------------------

def _engine(refs, arch, use_kernels=True):
    cfg, params = _port(refs, arch)
    return ServingEngine(cfg, _ccfg(), ServeConfig(BATCH, PROMPT, MAX_NEW), params,
                         device="cpu", use_kernels=use_kernels)


DENSE = tuple(a for a in ARCHS if a != DSMOE)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel-route", "plain"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_match_reference(refs, arch, use_kernels):
    """bf16 logits within one bf16 ulp of the largest."""
    eng = _engine(refs, arch, use_kernels)
    with torch.inference_mode():
        logits, caches = registry.prefill(
            eng.params, {"tokens": torch.as_tensor(refs[arch]["batch"]["tokens"])}, eng.cfg,
            eng.ctx)
    got, want = to_np(logits), refs[arch]["logits"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2 ** -8 * np.abs(want).max()
    assert not caches["prefix"] and len(registry.cache_elements(caches)) == eng.cfg.n_layers


@pytest.mark.parametrize("arch", DENSE)
def test_lockstep_tokens_match_reference(refs, arch):
    eng = _engine(refs, arch)
    np.testing.assert_array_equal(eng.generate(refs[arch]["batch"])["tokens"],
                                  refs[arch]["lockstep"])
    assert eng.cache_bytes(eng.last_caches) == refs[arch]["lockstep_bytes"]


# ---- deepseek-moe-16b: the dense prefix layer, then the routed layers ---------------------

def _within_ulp(got, want):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel-route", "plain"])
def test_deepseek_moe_prefix_layer_matches_reference(refs, use_kernels):
    """Layer 0 (attention 16 / 16 heads, dense FFN) before any router: its
    attention output and the layer's output within one bf16 ulp of their
    largest; its cache is the tree's `prefix` element, walked by
    `cache_elements` with the routed layers'."""
    eng = _engine(refs, DSMOE, use_kernels)
    cfg, ref = eng.cfg, refs[DSMOE]
    toks = torch.as_tensor(ref["batch"]["tokens"])
    p0 = eng.params["prefix"]["layer0"]
    with torch.inference_mode():
        x = lm.embed_inputs(eng.params, cfg, toks)
        y, _ = attention.gqa_forward(p0["attn"], common.rms_norm(x, p0["ln1"], cfg.norm_eps),
                                     cfg, probe=eng.ctx.probe, q_block=eng.ctx.q_block,
                                     use_kernel=use_kernels)
        x1, _, _ = blocks.apply_layer_full(p0, x, cfg, "attn", "dense", eng.ctx,
                                           build_cache=False)
        _, caches = registry.prefill(eng.params, {"tokens": toks}, cfg, eng.ctx)
    _within_ulp(y, ref["layer0_attn"])
    _within_ulp(x1, ref["prefix_out"])
    els = registry.cache_elements(caches)
    assert len(caches["prefix"]) == 1 and len(els) == cfg.n_layers and els[0] is caches["prefix"][0]
    assert els[0].k_win.shape[1] == cfg.n_kv_heads


def test_deepseek_moe_routed_layers_give_reference_logits(refs):
    """Fed the reference's prefix-layer output, the routed layers (64 ->
    4 experts top 2 and a shared one at smoke size) and the head give the
    reference's prefill logits bit for bit."""
    eng = _engine(refs, DSMOE)
    cfg, ref = eng.cfg, refs[DSMOE]
    x = to_torch(ref["prefix_out"])
    assert x.dtype == torch.bfloat16
    with torch.inference_mode():
        for layer, mixer, ffn, where in lm.layers(cfg)[1:]:
            assert ffn == "moe"
            x, _, _ = blocks.apply_layer_full(lm.layer_params(eng.params, where), x, cfg, mixer,
                                              ffn, eng.ctx, build_cache=False, layer=layer)
        logits = lm.unembed(eng.params, cfg, x[:, -1])
    np.testing.assert_array_equal(to_np(logits), ref["logits"])


def test_deepseek_moe_lockstep_tokens_match_reference(refs):
    """Through step 9 (the probe steps and the fold at step 8) on both rows;
    row 0 then takes another token at a near tie (module docstring)."""
    got = _engine(refs, DSMOE).generate(refs[DSMOE]["batch"])["tokens"]
    want = refs[DSMOE]["lockstep"]
    np.testing.assert_array_equal(got[:, :10], want[:, :10])
    np.testing.assert_array_equal(got[1], want[1])


# ---- the continuous engine ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_tokens_match_reference(refs, arch):
    cfg, params = _port(refs, arch)
    eng = ContinuousEngine(cfg, _ccfg(), ServeConfig(
        batch_size=BATCH, prompt_len=PROMPT, max_new_tokens=cr.CONT_NEW, **FREELIST),
        params, device="cpu")
    assert cr.scenario(eng, Request, cr.prompts(cfg.vocab)) == refs[arch]["continuous"]
    assert eng.cache_bytes(eng.caches) == refs[arch]["continuous_bytes"]
    eng._alloc.check_invariants()


# ---- qwen2's QKV bias ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", [QWEN, G7])
def test_qkv_bias_reaches_prefill_and_decode(refs, arch):
    """The random biases move the prefill logits and the tokens: the same
    run with the biases zeroed differs on both engines."""
    cfg, params = _port(refs, arch)
    assert cfg.qkv_bias and any(
        bool(params["groups"][f"sub{j}"]["attn"][k].float().abs().sum() > 0)
        for j in range(cfg.scan_group) for k in cr.BIAS_KEYS)
    zeroed = {**params, "groups": {
        name: {**sub, "attn": {k: torch.zeros_like(v) if k in cr.BIAS_KEYS else v
                               for k, v in sub["attn"].items()}}
        for name, sub in params["groups"].items()}}
    toks = torch.as_tensor(refs[arch]["batch"]["tokens"])
    runs = []
    for p in (params, zeroed):
        eng = ServingEngine(cfg, _ccfg(), ServeConfig(BATCH, PROMPT, MAX_NEW), p, device="cpu")
        with torch.inference_mode():
            logits, _ = registry.prefill(p, {"tokens": toks}, cfg, eng.ctx)
        runs.append((to_np(logits), eng.generate(refs[arch]["batch"])["tokens"]))
    (lb, tb), (lz, tz) = runs
    np.testing.assert_array_equal(tb, refs[arch]["lockstep"])
    assert np.abs(lb - lz).max() > 1e-2 and not np.array_equal(tb, tz)


# ---- the serve CLI -------------------------------------------------------------------------

@pytest.mark.parametrize("continuous", [False, True], ids=["lockstep", "continuous"])
@pytest.mark.parametrize("arch", NEW)
def test_serve_cli_runs_on_cpu(arch, continuous):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
            "--max-new", "4"]
    if continuous:
        argv += ["--continuous", "--requests", "3", "--backend", "paged", "--page-allocator",
                 "freelist", "--pool-fraction", "0.75", "--paged-kernel", "on", "--page-size",
                 "8"]
    out = serve.main(argv)
    if continuous:
        assert len(out) == 3 and all(len(r.tokens) == 4 for r in out.values())
    else:
        assert out["tokens"].shape == (2, 4)
