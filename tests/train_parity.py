"""Helpers shared by the port's training parity tests
(`tests/test_torch_train_{families,ssm,layers}.py`): the port's loss and
gradients, their check against a `tests/train_reference.py` loss job, the
remat check, and a seeded training batch of any family."""

import numpy as np
import torch

from repro_torch import configs, convert, tree
from tests.torch_parity import rel_l2

# leaves reduced over every token (or over heads, for MLA's shared rope key)
SUMMED = ("ln1", "ln2", "ln_x", "final_norm", "enc_norm", "kv_norm", "norm_w", "w_kpe",
          "router", "conv_x_w", "conv_x_b", "conv_B_w", "conv_B_b", "conv_C_w", "conv_C_b",
          "A_log", "D", "dt_bias")
LOSS_REL = 1e-4


def port_loss_and_grads(params, batch, cfg, remat: bool = True):
    """The port's training loss of `batch` and its gradients in flatten
    order: through `registry.loss_fn` (remat on), or with remat off
    through the forward the loss wraps (`lm.forward` / `encdec.forward`)."""
    from repro_torch.models import common, encdec, lm, registry

    leaves = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
    p = tree.unflatten(params, leaves)
    if remat:
        loss, met = registry.loss_fn(p, batch, cfg)
    else:
        labels = batch["labels"]
        if cfg.encdec:
            logits, _ = encdec.forward(p, batch["frontend_embeds"], batch["tokens"], cfg,
                                       remat=False)
            aux = 0.0
        else:
            out = lm.forward(p, batch["tokens"], cfg,
                             frontend_embeds=batch.get("frontend_embeds"), remat=False)
            logits, aux = out.logits[:, -labels.shape[1]:], out.aux_loss
        loss, met = common.cross_entropy_loss(logits, labels) + aux, None
    return loss, met, torch.autograd.grad(loss, leaves)


def check_against_reference(ref, arch, leaf_tol, summed_tol):
    """The port's loss, aux loss and gradients on a loss job's parameters and
    batch, held to the job's: the loss and the aux within LOSS_REL, each
    gradient leaf within `leaf_tol` relative L2 (`summed_tol` for SUMMED
    leaves).  Returns {leaf: relative L2}, the parameters, the batch."""
    cfg = configs.get_arch(arch, smoke=True)
    params = convert.from_jax_params(ref["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, met, grads = port_loss_and_grads(params, batch, cfg)
    assert abs(loss.item() - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
    want_aux = ref["metrics"]["aux"]
    assert met["aux"].dtype == torch.float32
    assert abs(met["aux"].item() - want_aux) <= LOSS_REL * abs(want_aux)
    assert (want_aux > 0) == bool(cfg.n_experts)
    named = tree.named_leaves(params)
    assert len(grads) == len(ref["grads"]) == len(named)
    rel = {}
    for (name, p), g, want in zip(named, grads, ref["grads"]):
        assert g.dtype == p.dtype, name
        rel[name] = rel_l2(want, g)
        tol = summed_tol if name.split("/")[-1] in SUMMED else leaf_tol
        assert rel[name] <= tol, (name, rel[name])
    return rel, params, batch


def family_batch(cfg, seed=4, length=40, b=2):
    """A training batch of b x `length` positions from a numpy seed, shaped
    as the pipeline shapes it (f32 frames or frontend embeddings)."""
    rng = np.random.default_rng(seed)
    n_front = cfg.n_frontend_tokens if cfg.frontend != "none" else 0
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, length + 1 - n_front))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec or n_front:
        n = length if cfg.encdec else n_front
        batch["frontend_embeds"] = torch.from_numpy(
            rng.standard_normal((b, n, cfg.d_model)).astype(np.float32))
    return batch


def remat_is_bitwise(arch):
    """remat on and off give bitwise equal losses and gradients."""
    from repro_torch.models import registry

    cfg = configs.get_arch(arch, smoke=True)
    params = registry.materialize_params(cfg, seed=2, device="cpu")
    batch = family_batch(cfg)
    loss_r, _, g_r = port_loss_and_grads(params, batch, cfg, remat=True)
    loss_n, _, g_n = port_loss_and_grads(params, batch, cfg, remat=False)
    assert torch.equal(loss_r, loss_n)
    for a, b in zip(g_r, g_n):
        assert torch.equal(a, b)
