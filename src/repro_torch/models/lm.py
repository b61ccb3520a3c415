"""Decoder-only LM (port of `repro.models.lm`, dense decoder-only).

Parameters keep the reference's layout: `groups` holds every layer's
weights stacked on a leading layer axis (`groups.sub0.{ln1, ln2,
attn.{wq,wk,wv,wo}, mlp.{w_gate,w_up,w_down}}`); a Python loop over the
layer axis replaces `lax.scan`.  Caches are {"prefix": [], "groups":
[{"sub0": MixedKVCache} per layer]}.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import precision as precision_lib
from repro_torch.models import blocks, common
from repro_torch.models.common import ParamDef


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab rounded up to a 256 multiple; unembed masks the padding."""
    return -(-cfg.vocab // 256) * 256


def lm_schema(cfg: ArchConfig) -> dict:
    e, v = cfg.d_model, padded_vocab(cfg)
    s: Dict[str, Any] = {
        "embed": ParamDef((v, e), init="embed"),
        "final_norm": ParamDef((e,), init="ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamDef((e, v))
    s["groups"] = common.stack_schema(blocks.group_schema(cfg), cfg.n_scan_groups)
    return s


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """-1e30 on the vocab-padding columns."""
    if logits.shape[-1] == vocab:
        return logits
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab
    return logits.masked_fill(pad, -1e30)


def unembed(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = common.matmul(x, params["embed"].T)
    else:
        logits = common.einsum("...e,ev->...v", x, params["lm_head"])
    return mask_padded_vocab(logits, cfg.vocab)


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            ctx: blocks.RunCtx) -> Tuple[torch.Tensor, Any]:
    """Serving prefill: forward + per-layer ZipCache compression (Alg. 2).
    Returns (logits at the last position (b, vocab), caches)."""
    x = common.embed_lookup(params["embed"], tokens)
    groups = []
    for i in range(cfg.n_scan_groups):
        x, el = blocks.apply_layer_full(common.layer_slice(params["groups"]["sub0"], i),
                                        x, cfg, ctx, build_cache=True, layer=i)
        groups.append({"sub0": el})
    return unembed(params, cfg, x[:, -1]), {"prefix": [], "groups": groups}


def decode_step(params: dict, token: torch.Tensor, caches: Any, cfg: ArchConfig,
                ctx: blocks.RunCtx, is_probe, active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step against the quantized caches (paper Alg. 3).

    is_probe: the step's probe flag (host bool), or a (b,) device tensor
    of per-row flags (each request of a continuous batch probes on its own
    token counter), passed only when some row probes.  active: optional
    (b,) bool device tensor of live slots; inactive rows neither append nor
    advance their counters."""
    x_t = common.embed_lookup(params["embed"], token)
    groups = []
    for i, gc in enumerate(caches["groups"]):
        x_t, el = blocks.apply_layer_decode(common.layer_slice(params["groups"]["sub0"], i),
                                            x_t, cfg, gc["sub0"], ctx, is_probe, active)
        groups.append({"sub0": el})
    return unembed(params, cfg, x_t), {"prefix": [], "groups": groups}


def recompress_caches(caches: Any, cfg: ArchConfig, ctx: blocks.RunCtx,
                      rows: Optional[torch.Tensor] = None, slot: Optional[int] = None,
                      rung=None) -> Any:
    """Streaming recompression across all layers (paper Alg. 3).

    rows: optional (b,) bool device tensor: fold only those slots.  slot:
    fold exactly one slot through the backend's per-slot recompression
    (the paged layout's; excludes `rows`).  rung: optional downshift
    rung(s), a (b,) int tensor with `rows`, a scalar with `slot`: the folded
    slots' lo stores take max(1, base - rung) effective bits
    (`precision.rung_eff`)."""
    assert rows is None or slot is None, "pass rows OR slot, not both"
    be = ctx.backend

    def fold(el, layer):
        eff = ctx.layer_eff(layer, cfg.n_kv_heads, device=el.length.device)
        if rung is not None:
            eff = precision_lib.rung_eff(eff, rung, ctx.ccfg.high_bits, ctx.ccfg.low_bits)
        if slot is not None:
            return be.recompress_slot(el, slot, eff=eff)
        return be.recompress(el, rows=rows, eff=eff)

    return {"prefix": [], "groups": [{"sub0": fold(gc["sub0"], i)}
                                     for i, gc in enumerate(caches["groups"])]}


def init_caches(cfg: ArchConfig, ctx: blocks.RunCtx, b: int, dtype=torch.bfloat16,
                device=None) -> Any:
    """Empty caches for every layer."""
    return {"prefix": [],
            "groups": [{"sub0": ctx.backend.init_cache(b, cfg.n_kv_heads, cfg.hd,
                                                       ctx.max_cache_len, dtype, device=device)}
                       for _ in range(cfg.n_scan_groups)]}
