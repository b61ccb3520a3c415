"""The port's training loss and its gradients against the JAX package, on
the CPU (`registry.loss_fn`, `lm.forward`, `blocked_attention` and the
layers under autograd).

  * `registry.loss_fn` and its gradients against `jax.value_and_grad` of
    the reference's `registry.loss_fn` on the smoke configs of yi-6b,
    qwen2-7b (QKV biases drawn at random) and smollm-360m (tied
    embeddings), the same parameters and batch on both sides; the
    reference op by op in a child process with excess precision and the
    algebraic simplifier off (`tests/train_reference.py`), so that its
    forward pass rounds as the port's.  Tolerances: the loss within 1e-4
    relative: the blocked attention's f32 sums (P V over the keys) run in
    another order than XLA's, so a rare bf16 attention output rounds one
    ulp apart (ROADMAP.md §3), and through the tied unembedding that moves
    a logit by one bf16 ulp (2 of smollm's 7,680 layer-0 outputs here; the
    loss 8.0e-5 apart); the cross entropy alone, on the reference's own
    logits, within 1e-6; each gradient leaf within 1e-2 relative L2,
    except the leaves summed over every token of the batch (the norm
    weights and the QKV biases), within 2e-2: the reference sums those in
    bf16 (the vjp of a broadcast bf16 product reduces in bf16, ~1e-2 from
    the exact sum over 128 tokens, `test_reference_sums_broadcast_grads_in_bf16`),
    the port in f32.  Readings (this image): the loss 3.3e-7 (yi-6b),
    2.3e-6 (qwen2-7b), 8.0e-5 (smollm); weights and embeddings within
    2.2e-3 / 6.9e-3 / 6.9e-3; norm weights and biases within 9.6e-3 /
    1.5e-2 / 1.4e-2.
  * `remat=True` and `remat=False` give bitwise equal losses and gradients;
    the serving prefill (`forward(build_cache=True)`) gives a
    layer-by-layer walk's logits and caches bit for bit;
    the blocked attention's per-block recomputation leaves its outputs
    (and the probe column sums) bitwise those of a run without autograd.
  * at the reference's init (each stacked layer weight at std 1 /
    sqrt(layer count)) the bf16 gradients are rounding noise: over 30%
    relative L2 from a float64 run of the same weights (f32 in the
    attention scores and the loss); at `common.fan_in_init` of the same
    draws, within 2e-2.  So `chip_smoke.py` phase 4n (iii) holds the card's
    gradients to the CPU's at the fan-in init.  Readings (this image, smoke
    size, the worst leaf): 0.52 at the reference's init, 9.9e-3 at the
    fan-in one;
  * one train step of every other family (MoE, MLA, SSM, Jamba's hybrid
    group, the encoder-decoder, a frontend arch) on the training CLI's
    pipeline batch moves every parameter's master, its loss finite
    (`tests/test_torch_train_{families,ssm,layers}.py` hold those
    families against the reference); `train_batch_spec` equals the
    reference's for every config.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro_torch import configs, convert, tree
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import saliency as sal
from repro_torch.models import attention, blocks, common, lm, registry
from tests import train_reference as tr
from tests.torch_parity import rel_l2, torch_threads  # noqa: F401
from tests.train_parity import port_loss_and_grads

pytestmark = pytest.mark.usefixtures("torch_threads")
SUMMED = ("ln1", "ln2", "final_norm", "bq", "bk", "bv")   # reduced over every token


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return tr.run(tmp_path_factory.mktemp("train_loss") / "refs.pkl",
                  [f"loss:{a}" for a in tr.LOSS_ARCHS])


@pytest.mark.parametrize("arch", tr.LOSS_ARCHS)
def test_loss_and_grads_match_reference(refs, arch):
    ref = refs[f"loss:{arch}"]
    cfg = configs.get_arch(arch, smoke=True)
    params = convert.from_jax_params(ref["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, met, grads = port_loss_and_grads(params, batch, cfg)
    assert abs(loss.item() - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    assert abs(met["ce"].item() - ref["metrics"]["ce"]) <= 1e-4 * abs(ref["metrics"]["ce"])
    assert met["aux"].item() == ref["metrics"]["aux"] == 0.0
    names = [n for n, _ in tree.named_leaves(params)]
    assert len(grads) == len(ref["grads"]) == len(names)
    for name, g, want in zip(names, grads, ref["grads"]):
        assert g.dtype == torch.bfloat16 and want.dtype == ml_dtypes.bfloat16, name
        tol = 2e-2 if name.split("/")[-1] in SUMMED else 1e-2
        assert rel_l2(want, g) <= tol, (name, rel_l2(want, g))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((2, 24, 256)) * 6).astype(ml_dtypes.bfloat16)
    labels = rng.integers(0, 256, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.7).astype(np.int32) if masked else None
    want = float(jcommon.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                            None if mask is None else jnp.asarray(mask)))
    got = common.cross_entropy_loss(
        torch.from_numpy(logits.view(np.int16)).view(torch.bfloat16), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and abs(got.item() - want) <= 1e-6 * abs(want)


def test_reference_sums_broadcast_grads_in_bf16():
    """Why the summed leaves take 2e-2: the reference's gradient of a bf16
    weight broadcast over 128 tokens (a norm weight's) is ~1e-2 from the
    exact sum, where an f32 sum rounded once (the port's) is ~2e-3 (its
    bf16 products round first)."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 64, 64)).astype(ml_dtypes.bfloat16)
    g = rng.standard_normal((2, 64, 64)).astype(ml_dtypes.bfloat16)
    w = jnp.ones((64,), jnp.bfloat16)
    _, vjp = jax.vjp(lambda w: jnp.asarray(h) * w, w)
    exact = (h.astype(np.float64) * g.astype(np.float64)).sum((0, 1))
    ref_err = rel_l2(exact, vjp(jnp.asarray(g))[0])
    th, tg = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) for a in (h, g))
    tw = torch.ones(64, dtype=torch.bfloat16, requires_grad=True)
    (gw,) = torch.autograd.grad(th * tw, tw, tg)
    port_err = rel_l2(exact, gw)
    assert ref_err > 5e-3 and port_err < 3e-3, (ref_err, port_err)


def test_reference_init_leaves_bf16_gradients_to_rounding():
    cfg = configs.get_arch("smollm-360m", smoke=True)
    params = registry.materialize_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).zipf(1.3, (1, 129)) % cfg.vocab)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    worst = {}
    for init, p in (("reference", params), ("fan-in", common.fan_in_init(params))):
        _, _, g16 = port_loss_and_grads(p, batch, cfg)
        _, _, g64 = port_loss_and_grads(tree.tree_map(torch.Tensor.double, p), batch, cfg)
        worst[init] = max(rel_l2(b, a) for a, b in zip(g16, g64))
    assert worst["reference"] > 0.3 and worst["fan-in"] < 2e-2, worst


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-7b"])
def test_remat_is_bitwise(arch):
    cfg = configs.get_arch(arch, smoke=True)
    params = registry.materialize_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 41)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_r, _, g_r = port_loss_and_grads(params, batch, cfg, remat=True)
    loss_n, _, g_n = port_loss_and_grads(params, batch, cfg, remat=False)
    assert torch.equal(loss_r, loss_n)
    for a, b in zip(g_r, g_n):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_probe", [False, True])
def test_blocked_attention_remat_leaves_outputs_bitwise(use_probe):
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 6, 40, 16, generator=gen).to(torch.bfloat16)
    k = torch.randn(2, 2, 40, 16, generator=gen).to(torch.bfloat16)
    v = torch.randn(2, 2, 40, 16, generator=gen).to(torch.bfloat16)
    probe = sal.select_probes(40, "random", 0.2, 0, device="cpu") if use_probe else None
    with torch.no_grad():
        want, want_col = attention.blocked_attention(q, k, v, q_block=16, probe=probe)
    qg = q.clone().requires_grad_(True)
    got, got_col = attention.blocked_attention(qg, k, v, q_block=16, probe=probe)
    assert got.requires_grad and torch.equal(got.detach(), want)
    assert (got_col is None) == (not use_probe)
    if use_probe:
        assert torch.equal(got_col.detach(), want_col)
    (gq,) = torch.autograd.grad(got.float().sum(), qg)
    assert gq.shape == q.shape and torch.isfinite(gq.float()).all()


def test_forward_last_only_and_aux():
    cfg = configs.get_arch("yi-6b", smoke=True)
    params = registry.materialize_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 24)))
    with torch.no_grad():
        full = lm.forward(params, toks, cfg)
        last = lm.forward(params, toks, cfg, last_only=True)
    assert full.logits.shape == (2, 24, lm.padded_vocab(cfg)) and full.caches is None
    assert torch.equal(last.logits, full.logits[:, -1:])
    assert full.aux_loss.dtype == torch.float32 and full.aux_loss.item() == 0.0


def test_forward_with_caches_equals_prefill():
    """The serving prefill (forward(build_cache=True, last_only=True) under a
    serving context) against a layer-by-layer walk of `lm.layers` with each
    layer's own parameter slice: its last logits and caches, bit for bit."""
    from repro_torch.core import kvcache as kvc
    from repro_torch.launch import steps

    cfg = configs.get_arch("qwen2-7b", smoke=True)
    params = registry.materialize_params(cfg, seed=3, device="cpu")
    ctx = steps.serve_ctx(cfg, ShapeConfig("p", 32, 2, "prefill"), device="cpu",
                          use_kernels=False)
    toks = torch.from_numpy(np.random.default_rng(2).integers(2, cfg.vocab, (2, 32)))
    with torch.inference_mode():
        logits, caches = lm.prefill(params, toks, cfg, ctx)
        x, els = lm.embed_inputs(params, cfg, toks), []
        for layer, mixer, ffn, where in lm.layers(cfg):
            x, el, _ = blocks.apply_layer_full(lm.layer_params(params, where), x, cfg, mixer,
                                               ffn, ctx, build_cache=True, layer=layer)
            els.append(el)
        want_logits = lm.unembed(params, cfg, x[:, -1])
    assert torch.equal(logits, want_logits)
    got, want = registry.cache_elements(caches), els
    assert len(got) == len(want) == cfg.n_layers
    for a, b in zip(got, want):
        for x, y in zip(kvc.tree_leaves(a), kvc.tree_leaves(b)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-moe-16b", "mamba2-2.7b",
                                  "jamba-v0.1-52b", "seamless-m4t-medium", "llava-next-34b"])
def test_every_family_trains(arch):
    """One train step of each other family on the CPU, on the batch the
    training CLI's pipeline gives it (`train.data_config`: a frontend arch's
    embeddings before the text, the encoder-decoder's f32 frames): the loss
    and the gradient norm finite, the aux loss positive exactly for the MoE
    archs, and every parameter's f32 master moved."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps, train
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = configs.get_arch(arch, smoke=True)
    pipe = TokenPipeline(train.data_config(cfg, 48, 2, seed=3))
    batch = train.to_device(next(pipe), "cpu")
    pipe.close()
    assert ("frontend_embeds" in batch) == (cfg.encdec or cfg.frontend != "none")
    if "frontend_embeds" in batch:
        assert batch["frontend_embeds"].dtype == torch.float32
    params = registry.materialize_params(cfg, seed=1, device="cpu")
    before = [t.clone() for t in tree.leaves(params)]
    step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3), q_block=16)
    params, opt, met = step(params, adamw_init(params), batch)
    assert np.isfinite(met["loss"].item()) and np.isfinite(met["grad_norm"].item())
    assert (met["aux"].item() > 0) == bool(cfg.n_experts)
    # an update of ~lr leaves a weight near 1 (a norm's) where bf16 rounds it:
    # the f32 master moves
    moved = [not torch.equal(a.float(), b) for a, b in zip(before, tree.leaves(opt.master))]
    assert all(moved), [n for (n, _), m in zip(tree.named_leaves(params), moved) if not m]
    assert int(opt.count) == 1


@pytest.mark.parametrize("arch", sorted(jconfigs.all_archs()))
def test_train_batch_spec_matches_reference(arch):
    want = jregistry.train_batch_spec(jconfigs.get_arch(arch, smoke=True),
                                      JShapeConfig("train", 48, 4, "train"))
    got = registry.train_batch_spec(configs.get_arch(arch, smoke=True),
                                    ShapeConfig("train", 48, 4, "train"))
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in got.items():
        assert tuple(want[k].shape) == shape
        assert np.dtype(want[k].dtype).name == str(dtype).replace("torch.", ""), k
