"""Encoder-decoder backbone (port of `repro.models.encdec`, seamless-m4t):
an encoder over precomputed frame embeddings (the audio frontend is a
stub), then a decoder with self- and cross-attention.

ZipCache compresses both caches of every decoder layer:
  * the self-attention cache: streaming ZipCache (paper Alg. 2/3), as a
    decoder-only layer's;
  * the cross-attention cache: the encoder memory is static after `encode`,
    so it is compressed once at prefill, with the probe saliency of the
    decoder prefill's cross-attention rows (non-causal: every probe row sees
    every source position, `attention.probe_saliency_from_colsum`).  Decode
    reads it and never appends to it; only its probe state moves, on probe
    steps, and a fold leaves it as it is.

The encoder and the cross-attention prefill run the plain blocked attention
with f32 scores, as the reference wires them (no `use_kernel`); the
decoder's causal self-attention prefill takes the kernel route under
`ctx.use_kernels`.  The encoder runs in the dtype of the embeddings it is
given: the serve CLI passes f32, and f32 activations against bf16 weights
compute in f32, so the cross-attention K/V and the cross caches' store
parameters are f32 beside a bf16 window (`common.einsum` promotes).

Parameters keep the reference's layout: `embed`, `audio_proj`,
`enc_layers` and `dec_layers` (stacked on a leading layer axis; a Python
loop over it replaces `lax.scan`), `enc_norm`, `final_norm`, `lm_head`.
The training loss (`loss_fn`) is the CE over every decoder position; each
encoder and decoder layer is recomputed in its backward pass (`remat`).
Caches are {"prefix": [], "groups": [{"self": element, "cross": element}
per decoder layer]}: the decoder-only tree's shape, so every walk over a
cache tree (`registry.cache_elements` / `map_caches`, `backend.cache_bytes`,
the captured step's `adopt`) takes both elements of every layer.

On a mesh (`models.parallel`) the encoder's self-attention, the decoder's
self-attention and both MLPs split over `model` like the decoder-only
layers; the cross-attention and the frame projection gather their `model`
blocks on use and compute whole on every model rank (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import blocks, common, lm, parallel
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import ParamDef


def enc_layer_schema(cfg: ArchConfig) -> dict:
    e = cfg.d_model
    return {
        "ln1": ParamDef((e,), ("embed",), init="ones"),
        "attn": attn.gqa_schema(cfg),
        "ln2": ParamDef((e,), ("embed",), init="ones"),
        "mlp": mlp_mod.dense_mlp_schema(cfg),
    }


def dec_layer_schema(cfg: ArchConfig) -> dict:
    e = cfg.d_model
    return {
        "ln1": ParamDef((e,), ("embed",), init="ones"),
        "self_attn": attn.gqa_schema(cfg),
        "ln_x": ParamDef((e,), ("embed",), init="ones"),
        "cross_attn": common.computed_split(attn.gqa_schema(cfg), False),   # gathered whole
        "ln2": ParamDef((e,), ("embed",), init="ones"),
        "mlp": mlp_mod.dense_mlp_schema(cfg),
    }


def encdec_schema(cfg: ArchConfig) -> dict:
    e, v = cfg.d_model, lm.padded_vocab(cfg)
    return {
        "embed": ParamDef((v, e), ("vocab", "embed"), init="embed", split=True),
        "audio_proj": ParamDef((e, e), ("embed", "embed_out")),
        "enc_layers": common.stack_schema(enc_layer_schema(cfg), cfg.n_enc_layers),
        "enc_norm": ParamDef((e,), ("embed",), init="ones"),
        "dec_layers": common.stack_schema(dec_layer_schema(cfg), cfg.n_layers),
        "final_norm": ParamDef((e,), ("embed",), init="ones"),
        "lm_head": ParamDef((e, v), ("embed", "vocab"), split=True),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(params: dict, src_embeds: torch.Tensor, cfg: ArchConfig,
           ctx: Optional[blocks.RunCtx] = None, remat: bool = True) -> torch.Tensor:
    """(b, l_src, e) frame embeddings -> the encoder memory (b, l_src, e), in
    the embeddings' dtype (f32 embeddings promote the bf16 weights).
    remat: under autograd each layer runs under `torch.utils.checkpoint`,
    as the reference's `jax.checkpoint(layer)`."""
    q_block = ctx.q_block if ctx is not None else 512
    mesh = ctx.mesh if ctx is not None else None
    x = common.einsum("ble,ef->blf", src_embeds, params["audio_proj"])

    def layer(x, p):
        p = parallel.gather_tree(p, mesh)
        h = common.rms_norm(x, p["ln1"], cfg.norm_eps)
        y, _ = attn.gqa_forward(p["attn"], h, cfg, causal=False, q_block=q_block, mesh=mesh)
        x = x + y
        return x + mlp_mod.dense_mlp(p["mlp"], common.rms_norm(x, p["ln2"], cfg.norm_eps), mesh)

    use_ckpt = remat and torch.is_grad_enabled()
    for p in lm.stacked_slices(params["enc_layers"], cfg.n_enc_layers):
        x = checkpoint(layer, x, p, use_reentrant=False) if use_ckpt else layer(x, p)
    return common.rms_norm(x, params["enc_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder over the full prompt (prefill)
# ---------------------------------------------------------------------------

def _dec_layer_full(p: dict, x: torch.Tensor, enc_out: torch.Tensor, cfg: ArchConfig,
                    ctx: blocks.RunCtx, build_cache: bool) -> Tuple[torch.Tensor, Any]:
    """One decoder layer over the prompt.  Returns (x, {"self": cache,
    "cross": cache} | None); with build_cache, both caches are compressed,
    the cross cache over the whole source (its probe is the context's)."""
    p = parallel.gather_tree(p, ctx.mesh)
    h = common.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, aux_self = attn.gqa_forward(p["self_attn"], h, cfg, causal=True, probe=ctx.probe,
                                   q_block=ctx.q_block, use_kernel=ctx.use_kernels, mesh=ctx.mesh)
    x = x + y
    hx = common.rms_norm(x, p["ln_x"], cfg.norm_eps)
    cross_probe = ctx.probe if build_cache else None
    yx, aux_cross = attn.gqa_forward(p["cross_attn"], hx, cfg, causal=False, kv_x=enc_out,
                                     probe=cross_probe, q_block=ctx.q_block)
    x = x + yx
    x = x + mlp_mod.dense_mlp(p["mlp"], common.rms_norm(x, p["ln2"], cfg.norm_eps), ctx.mesh)
    if not build_cache:
        return x, None
    be = ctx.backend
    return x, {
        "self": be.compress_prefill(aux_self.k, aux_self.v, aux_self.saliency,
                                    ctx.max_cache_len, probe_nnz=aux_self.probe_nnz,
                                    dtype=x.dtype),
        "cross": be.compress_prefill(aux_cross.k, aux_cross.v, aux_cross.saliency,
                                     enc_out.shape[1], probe_nnz=aux_cross.probe_nnz,
                                     dtype=x.dtype),
    }


def forward(params: dict, src_embeds: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig,
            ctx: Optional[blocks.RunCtx] = None, build_cache: bool = False, remat: bool = True
            ) -> Tuple[torch.Tensor, Any]:
    """Teacher-forced seq2seq forward.  Returns (logits, caches | None); with
    build_cache (prefill) only the last position's logits, (b, 1, vocab),
    and the cache tree.  The vocabulary's padding columns are masked.

    remat: under autograd every encoder layer, and every decoder layer
    unless build_cache, runs under `torch.utils.checkpoint` and is
    recomputed in the backward pass, as the reference's `jax.checkpoint`s:
    only each layer's input is kept.  It does not change a bit of the loss
    or the gradients."""
    ctx = ctx or blocks.RunCtx()
    params = lm.top_level(params, ctx.mesh)
    enc_out = encode(params, src_embeds, cfg, ctx, remat=remat)
    x = common.embed_lookup(params["embed"], tokens, ctx.mesh)

    def layer(x, p):
        return _dec_layer_full(p, x, enc_out, cfg, ctx, build_cache)

    use_ckpt = remat and not build_cache and torch.is_grad_enabled()
    groups = []
    for p in lm.stacked_slices(params["dec_layers"], cfg.n_layers):
        x, el = checkpoint(layer, x, p, use_reentrant=False) if use_ckpt else layer(x, p)
        groups.append(el)
    if not build_cache:
        return lm.unembed(params, cfg, x, ctx.mesh), None
    return lm.unembed(params, cfg, x[:, -1:], ctx.mesh), {"prefix": [], "groups": groups}


def loss_fn(params: dict, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            ctx: Optional[blocks.RunCtx] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE over every decoder position (batch: frontend_embeds, the
    source frames (b, l_src, e); tokens, labels (b, l); optional mask) and
    a zero aux loss, as the reference's."""
    ctx = ctx or blocks.RunCtx()
    logits, _ = forward(params, batch["frontend_embeds"], batch["tokens"], cfg, ctx)
    ce = common.cross_entropy_loss(logits, batch["labels"], batch.get("mask"),
                                   vocab_offset=lm.vocab_offset(cfg, logits.shape[-1], ctx.mesh),
                                   mesh=ctx.mesh, data_axes=ctx.data_axes)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device)}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_step(params: dict, token: torch.Tensor, caches: Any, cfg: ArchConfig,
                ctx: blocks.RunCtx, is_probe, active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Any]:
    """One decoder token.  The self cache takes the token's K/V (inactive
    rows of `active` append nothing); the cross cache is read, with no
    rotary on its query, and only its probe state moves.  Both take the
    exact decode algebra on the plain route, as the reference's (which
    passes no `decode_impl`).  Returns (logits (b, vocab), caches).  On a
    serving mesh the self-attention heads, the MLP width and the vocabulary
    compute on each rank's block where they split (`lm.decode_step`'s
    rule); the cross-attention's weights are gathered on use."""
    params = lm.top_level(params, ctx.mesh, decode=True)
    x_t = common.embed_lookup(params["embed"], token, ctx.mesh)
    be = ctx.backend
    groups = []
    for i, gc in enumerate(caches["groups"]):
        p = parallel.gather_tree(common.layer_slice(params["dec_layers"], i), ctx.mesh,
                                 decode=True)
        self_cache, cross_cache = gc["self"], gc["cross"]
        h = common.rms_norm(x_t, p["ln1"], cfg.norm_eps)
        q_t, k_t, v_t = attn.gqa_decode_qkv(p["self_attn"], h, cfg, self_cache.length, ctx.mesh)
        self_cache = be.append(self_cache, k_t, v_t, active=active)
        dec = be.attend(q_t, self_cache, is_probe)
        self_cache = be.update_probe(self_cache, dec.slot_weights, is_probe)
        x_t = x_t + attn.decode_out_proj(dec.out, p["self_attn"]["wo"], ctx.mesh)

        hx = common.rms_norm(x_t, p["ln_x"], cfg.norm_eps)
        qx = common.einsum("be,ehd->bhd", hx, p["cross_attn"]["wq"])
        decx = be.attend(qx, cross_cache, is_probe)
        cross_cache = be.update_probe(cross_cache, decx.slot_weights, is_probe)
        x_t = x_t + common.out_proj(decx.out, p["cross_attn"]["wo"])

        x_t = x_t + mlp_mod.dense_mlp(p["mlp"], common.rms_norm(x_t, p["ln2"], cfg.norm_eps),
                                      ctx.mesh)
        groups.append({"self": self_cache, "cross": cross_cache})
    return lm.decode_logits(params, cfg, x_t, ctx.mesh), {"prefix": [], "groups": groups}


def recompress(caches: Any, ctx: blocks.RunCtx, rows: Optional[torch.Tensor] = None) -> Any:
    """Fold every self cache's window (rows: only those slots); the cross
    caches pass through untouched."""
    return {"prefix": [], "groups": [{"self": ctx.backend.recompress(gc["self"], rows=rows),
                                      "cross": gc["cross"]} for gc in caches["groups"]]}


def init_caches(cfg: ArchConfig, ctx: blocks.RunCtx, b: int, l_src: int,
                dtype=torch.bfloat16, device=None) -> Any:
    """Empty caches: each decoder layer's self cache sized max_cache_len, its
    cross cache l_src."""
    def one():
        return {"self": ctx.backend.init_cache(b, cfg.n_kv_heads, cfg.hd, ctx.max_cache_len,
                                               dtype, device=device),
                "cross": ctx.backend.init_cache(b, cfg.n_kv_heads, cfg.hd, l_src, dtype,
                                                device=device)}
    return {"prefix": [], "groups": [one() for _ in range(cfg.n_layers)]}
