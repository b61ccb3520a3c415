"""Decoder-only LM and the frontend archs' trunk (port of `repro.models.lm`).

Parameters keep the reference's layout: optional unrolled prefix layers
(`prefix.layer{i}`, DeepSeek's first dense layer) before `groups`, which
holds every later layer's weights stacked on a leading group axis
(`groups.sub{j}.{ln1, ln2, attn.*, mlp.* | moe.*}`); a Python loop over the
group axis replaces `lax.scan`.  Caches are {"prefix": [element per prefix
layer], "groups": [{"sub{j}": element} per group]}, each element a
`MixedKVCache` or `PagedKVCache` for an attention layer and an
`ssm.SSMState` for an SSM layer (mamba2's every layer, seven of Jamba's
eight).  The absolute layer of group g's sub-layer j is first_dense_layers
+ g * scan_group + j, SSM layers counted (the precision map's index).  A
frontend arch (llava's vision stub) adds `vision_proj` or `audio_proj`,
and its prefill prepends the projected frontend embeddings to the text
(`embed_inputs`).

On a mesh (`models.parallel`) the forward gathers each layer's weights as
the layer starts (again in its recomputation) and the top-level leaves once;
the logits are this model rank's slice of the vocabulary where the
vocabulary splits, and `loss_fn` takes a cross entropy reduced over the
slices.  The frontend projection is gathered whole.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.core import precision as precision_lib
from repro_torch.models import blocks, common, parallel
from repro_torch.models.common import ParamDef


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab rounded up to a 256 multiple; unembed masks the padding."""
    return -(-cfg.vocab // 256) * 256


def lm_schema(cfg: ArchConfig) -> dict:
    e, v = cfg.d_model, padded_vocab(cfg)
    s: Dict[str, Any] = {
        "embed": ParamDef((v, e), ("vocab", "embed"), init="embed", split=True),
        "final_norm": ParamDef((e,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamDef((e, v), ("embed", "vocab"), split=True)
    if cfg.first_dense_layers:
        s["prefix"] = {f"layer{i}": blocks.layer_schema(cfg, m, f)
                       for i, (m, f) in enumerate(cfg.prefix_kinds())}
    s["groups"] = common.stack_schema(blocks.group_schema(cfg), cfg.n_scan_groups)
    if cfg.frontend == "vision":
        s["vision_proj"] = ParamDef((e, e), ("embed", "embed_out"))
    elif cfg.frontend == "audio":
        s["audio_proj"] = ParamDef((e, e), ("embed", "embed_out"))
    return s


def embed_inputs(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """tokens (b, l_text) [+ frontend embeddings (b, l_front, e)] -> (b, l, e):
    the embeddings, cast to the token embeddings' dtype and projected
    (`vision_proj` or `audio_proj`), go before the text."""
    x = common.embed_lookup(params["embed"], tokens, mesh)
    if frontend_embeds is None:
        return x
    proj = params["vision_proj"] if "vision_proj" in params else params["audio_proj"]
    fe = common.einsum("ble,ef->blf", frontend_embeds.to(x.dtype), proj)
    return torch.cat([fe, x], dim=1)


def layers(cfg: ArchConfig):
    """Every layer in order: (absolute layer, mixer, ffn, where), `where`
    ("prefix", i) for prefix layer i, ("groups", g, "sub{j}") for group g's
    sub-layer j: the paths of its parameters and its cache element."""
    out = [(i, m, f, ("prefix", i)) for i, (m, f) in enumerate(cfg.prefix_kinds())]
    for g in range(cfg.n_scan_groups):
        for j, (m, f) in enumerate(cfg.layer_kinds()):
            out.append((cfg.first_dense_layers + g * cfg.scan_group + j, m, f,
                        ("groups", g, f"sub{j}")))
    return out


def layer_params(params: dict, where) -> dict:
    if where[0] == "prefix":
        return params["prefix"][f"layer{where[1]}"]
    return common.layer_slice(params["groups"][where[2]], where[1])


def _cache_tree(cfg: ArchConfig, elements) -> Any:
    """Cache elements in `layers(cfg)` order -> the cache tree."""
    elements = list(elements)
    n_prefix = cfg.first_dense_layers
    keys = [f"sub{j}" for j in range(cfg.scan_group)]
    body = elements[n_prefix:]
    return {"prefix": elements[:n_prefix],
            "groups": [dict(zip(keys, body[g * len(keys):(g + 1) * len(keys)]))
                       for g in range(len(body) // len(keys))]}


def cache_element(caches: Any, where) -> Any:
    if where[0] == "prefix":
        return caches["prefix"][where[1]]
    return caches["groups"][where[1]][where[2]]


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """-1e30 on the vocab-padding columns."""
    if logits.shape[-1] == vocab:
        return logits
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab
    return logits.masked_fill(pad, -1e30)


def unembed(params: dict, cfg: ArchConfig, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The logits; on a mesh whose `model` axis splits the vocabulary, this
    rank's slice of them (`vocab_offset` says where it starts)."""
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    dt, split = x.dtype, parallel.is_split(w)
    if split:
        x = parallel.enter(x, mesh)
    if cfg.tie_embeddings:
        logits = common.matmul(x, w.T).to(dt)
    else:
        logits = common.einsum("...e,ev->...v", x, w).to(dt)
    if split:
        off = vocab_offset(cfg, logits.shape[-1], mesh)
        pad = torch.arange(off, off + logits.shape[-1], device=logits.device) >= cfg.vocab
        return logits.masked_fill(pad, -1e30)
    return mask_padded_vocab(logits, cfg.vocab)


def vocab_offset(cfg: ArchConfig, width: int, mesh=None) -> Optional[int]:
    """Where a logits slice `width` columns wide starts in the vocabulary:
    None for the whole vocabulary, else this model rank's slice."""
    if width == padded_vocab(cfg):
        return None
    return parallel.coord("model", mesh) * width


def top_level(params: dict, mesh,
              stacked=("prefix", "groups", "enc_layers", "dec_layers"),
              decode: bool = False) -> dict:
    """The parameters with every top-level leaf gathered for use on a mesh
    (the layer trees are gathered layer by layer as each runs); decode: as
    the serving decode step uses them (`parallel.gather`)."""
    if mesh is None:
        return params
    return {k: (v if k in stacked else parallel.gather_tree(v, mesh, decode))
            for k, v in params.items()}


def decode_logits(params: dict, cfg: ArchConfig, x_t: torch.Tensor, mesh=None) -> torch.Tensor:
    """A decode step's logits over the whole (padded) vocabulary: a
    vocabulary split over `model` gathers its slices."""
    logits = unembed(params, cfg, x_t, mesh)
    if vocab_offset(cfg, logits.shape[-1], mesh) is None:
        return logits
    return parallel.all_gather_dim(logits, logits.dim() - 1, mesh, "model")


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    caches: Any            # None in the training forward


def stacked_slices(stacked: dict, n: int) -> list:
    """Weights stacked on a leading layer (or group) axis as n per-layer
    trees of views.  One `unbind` per leaf: its backward stacks the n
    layers' gradients in one op."""
    per_leaf = [parallel.unbind(t) for t in tree_lib.leaves(stacked)]
    return [tree_lib.unflatten(stacked, [u[g] for u in per_leaf]) for g in range(n)]


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            ctx: Optional[blocks.RunCtx] = None,
            frontend_embeds: Optional[torch.Tensor] = None, build_cache: bool = False,
            remat: bool = True, last_only: bool = False) -> ForwardOut:
    """Full-sequence forward: the train loss's, and with build_cache and
    last_only the serving prefill's.  Returns the logits (b, l, vocab), or
    the last position's with `last_only`, the summed aux loss (f32) and,
    with build_cache, the cache tree.

    remat: under autograd each scan group runs under `torch.utils.checkpoint`
    and is recomputed in the backward pass, as the reference's
    `jax.checkpoint(group_fn, policy=nothing_saveable)`: only each group's
    input is kept.  It does not change a bit of the loss or the gradients."""
    ctx = ctx or blocks.RunCtx()
    params = top_level(params, ctx.mesh)
    x = embed_inputs(params, cfg, tokens, frontend_embeds, ctx.mesh)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    els = []
    for i, (m, f) in enumerate(cfg.prefix_kinds()):
        x, el, aux = blocks.apply_layer_full(params["prefix"][f"layer{i}"], x, cfg, m, f, ctx,
                                             build_cache, layer=i)
        aux_total = aux_total + aux
        els.append(el)

    use_ckpt = remat and not build_cache and torch.is_grad_enabled()
    for g, gparams in enumerate(stacked_slices(params["groups"], cfg.n_scan_groups)):
        args = (gparams, x, cfg, ctx, build_cache, g)
        x, group_els, aux = (checkpoint(blocks.apply_group_full, *args, use_reentrant=False)
                             if use_ckpt else blocks.apply_group_full(*args))
        aux_total = aux_total + aux
        els.extend(group_els)

    logits = unembed(params, cfg, x[:, -1:] if last_only else x, ctx.mesh)
    return ForwardOut(logits, aux_total, _cache_tree(cfg, els) if build_cache else None)


def loss_fn(params: dict, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            ctx: Optional[blocks.RunCtx] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (+ the aux loss).  batch: tokens (b, l), labels (b, l),
    optional mask; a frontend arch's labels cover the text only."""
    ctx = ctx or blocks.RunCtx()
    out = forward(params, batch["tokens"], cfg, ctx,
                  frontend_embeds=batch.get("frontend_embeds"))
    lf = out.logits[:, -batch["labels"].shape[1]:]  # frontend tokens carry no labels
    ce = common.cross_entropy_loss(lf, batch["labels"], batch.get("mask"),
                                   vocab_offset=vocab_offset(cfg, lf.shape[-1], ctx.mesh),
                                   mesh=ctx.mesh, data_axes=ctx.data_axes)
    return ce + out.aux_loss, {"ce": ce, "aux": out.aux_loss}


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig, ctx: blocks.RunCtx,
            frontend_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Any]:
    """Serving prefill: forward + per-layer ZipCache compression (Alg. 2).
    frontend_embeds: a frontend arch's embeddings, prepended to the text
    (`embed_inputs`); the query sequence, and so the probes, covers both.
    Returns (logits at the last position (b, vocab), caches)."""
    out = forward(params, tokens, cfg, ctx, frontend_embeds, build_cache=True, remat=False,
                  last_only=True)
    return out.logits[:, 0], out.caches


def decode_step(params: dict, token: torch.Tensor, caches: Any, cfg: ArchConfig,
                ctx: blocks.RunCtx, is_probe, active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step against the quantized caches (paper Alg. 3).

    is_probe: the step's probe flag (host bool), or a (b,) device tensor
    of per-row flags (each request of a continuous batch probes on its own
    token counter), passed only when some row probes.  active: optional
    (b,) bool device tensor of live slots; inactive rows neither append nor
    advance their counters."""
    params = top_level(params, ctx.mesh, decode=True)
    x_t = common.embed_lookup(params["embed"], token, ctx.mesh)
    els = []
    for _, mixer, ffn, where in layers(cfg):
        x_t, el = blocks.apply_layer_decode(layer_params(params, where), x_t, cfg, mixer, ffn,
                                            cache_element(caches, where), ctx, is_probe,
                                            active)
        els.append(el)
    return decode_logits(params, cfg, x_t, ctx.mesh), _cache_tree(cfg, els)


def recompress_caches(caches: Any, cfg: ArchConfig, ctx: blocks.RunCtx,
                      rows: Optional[torch.Tensor] = None, slot: Optional[int] = None,
                      rung=None) -> Any:
    """Streaming recompression across all layers (paper Alg. 3).

    rows: optional (b,) bool device tensor: fold only those slots.  slot:
    fold exactly one slot through the backend's per-slot recompression
    (the paged layout's; excludes `rows`).  rung: optional downshift
    rung(s), a (b,) int tensor with `rows`, a scalar with `slot`: the folded
    slots' lo stores take max(1, base - rung) effective bits
    (`precision.rung_eff`).  MLA layers pool the precision map onto their
    one latent head.  SSM states pass through: there is no window to fold."""
    assert rows is None or slot is None, "pass rows OR slot, not both"
    be = ctx.backend

    def fold(el, layer, mixer):
        if mixer == "ssm":
            return el
        eff = ctx.layer_eff(layer, blocks.cache_heads(cfg, mixer), device=el.length.device)
        if rung is not None:
            eff = precision_lib.rung_eff(eff, rung, ctx.ccfg.high_bits, ctx.ccfg.low_bits)
        if slot is not None:
            return be.recompress_slot(el, slot, eff=eff)
        return be.recompress(el, rows=rows, eff=eff)

    return _cache_tree(cfg, [fold(cache_element(caches, where), layer, mixer)
                             for layer, mixer, _, where in layers(cfg)])


def init_caches(cfg: ArchConfig, ctx: blocks.RunCtx, b: int, dtype=torch.bfloat16,
                device=None) -> Any:
    """Empty caches for every layer."""
    return _cache_tree(cfg, [blocks.init_layer_cache(cfg, ctx, mixer, b, dtype, device=device)
                             for _, mixer, _, _ in layers(cfg)])
