"""Model API of the port (port of `repro.models.registry`): schema, the
training loss, prefill, decode, recompression and the cache-tree walks,
over the decoder-only models (`lm`, frontend archs included) and the
encoder-decoder (`encdec`).
Both cache trees have one shape, {"prefix": [...], "groups": [{key:
element}, ...]}, so every walk here takes either."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import blocks, common, encdec, lm
from repro_torch.models.ssm import SSMState


def schema(cfg: ArchConfig) -> dict:
    return encdec.encdec_schema(cfg) if cfg.encdec else lm.lm_schema(cfg)


def materialize_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    return common.materialize(schema(cfg), seed, device=device)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            ctx: Optional[blocks.RunCtx] = None):
    """(loss, {"ce", "aux"}) of a training batch (`train_batch_spec`), for
    every family: the encoder-decoder's `encdec.loss_fn`, else the decoder's
    `lm.loss_fn` (the MoE aux loss added, a frontend arch's labels over its
    text only)."""
    if cfg.encdec:
        return encdec.loss_fn(params, batch, cfg, ctx)
    return lm.loss_fn(params, batch, cfg, ctx)


def train_batch_spec(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """{name: (shape, dtype)} of a training batch, the reference's spec
    (frontend embeddings in bf16, tokens and labels int32)."""
    b, l = shape.global_batch, shape.seq_len
    if cfg.encdec:
        return {"frontend_embeds": ((b, l, cfg.d_model), torch.bfloat16),
                "tokens": ((b, l), torch.int32), "labels": ((b, l), torch.int32)}
    if cfg.frontend != "none":
        n_f = cfg.n_frontend_tokens
        return {"frontend_embeds": ((b, n_f, cfg.d_model), torch.bfloat16),
                "tokens": ((b, l - n_f), torch.int32), "labels": ((b, l - n_f), torch.int32)}
    return {"tokens": ((b, l), torch.int32), "labels": ((b, l), torch.int32)}


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, ctx: blocks.RunCtx):
    """batch: {"tokens": (b, l) int[, "frontend_embeds": (b, n, e)]}: the
    encoder-decoder's source frames, or a frontend arch's embeddings put
    before the text.  Returns (logits at the last position (b, vocab),
    caches)."""
    if cfg.encdec:
        logits, caches = encdec.forward(params, batch["frontend_embeds"], batch["tokens"], cfg,
                                        ctx, build_cache=True)
        return logits[:, -1], caches
    return lm.prefill(params, batch["tokens"], cfg, ctx,
                      frontend_embeds=batch.get("frontend_embeds"))


def decode_step(params, token: torch.Tensor, caches: Any, cfg: ArchConfig,
                ctx: blocks.RunCtx, is_probe, active: Optional[torch.Tensor] = None):
    """is_probe: a host bool or per-row flags; active: optional (b,) live-slot
    mask (continuous batching: masked slots neither append nor advance)."""
    if cfg.encdec:
        return encdec.decode_step(params, token, caches, cfg, ctx, is_probe, active)
    return lm.decode_step(params, token, caches, cfg, ctx, is_probe, active)


def recompress(caches: Any, cfg: ArchConfig, ctx: blocks.RunCtx,
               rows: Optional[torch.Tensor] = None, slot: Optional[int] = None, rung=None):
    """rows: fold only those slots; slot: fold one slot through the backend's
    per-slot recompression (paged layout); rung: the downshift rung(s) of
    the folded slots ((b,) with rows, a scalar with slot).  The
    encoder-decoder folds its self caches only and takes neither `slot`
    nor `rung`, as the reference asserts."""
    if cfg.encdec:
        if slot is not None:
            raise ValueError("per-slot recompression: decoder-only caches only")
        if rung is not None:
            raise ValueError("the downshift ladder: decoder-only caches only")
        return encdec.recompress(caches, ctx, rows=rows)
    return lm.recompress_caches(caches, cfg, ctx, rows=rows, slot=slot, rung=rung)


def cache_elements(caches: Any) -> list:
    """Every cache element of a cache tree in layer order: the prefix layers'
    (DeepSeek's first dense layer), then each group's sub-layers'.  An SSM
    layer's element is its `SSMState`; every other one is a KV cache."""
    return list(caches["prefix"]) + [el for gc in caches["groups"] for el in gc.values()]


def map_caches(fn, *trees) -> Any:
    """The cache tree of fn(elements of `trees` at the same layer), over the
    prefix layers and the groups alike."""
    first = trees[0]
    return {"prefix": [fn(*els) for els in zip(*(t["prefix"] for t in trees))],
            "groups": [{key: fn(*(t["groups"][i][key] for t in trees)) for key in gc}
                       for i, gc in enumerate(first["groups"])]}


def insert_caches(dst: Any, src: Any, slot: int) -> Any:
    """Insert a 1-request cache slice into batch row `slot` of a decode batch:
    paged elements scatter onto the slot's pages, mixed ones and SSM states
    write rows."""
    from repro_torch.core import kvcache as kvc
    from repro_torch.core import paged

    def ins(d, s):
        if isinstance(d, paged.PagedKVCache):
            return paged.insert_slot(d, s, slot)
        return kvc.tree_update_rows(d, s, slot)

    return map_caches(ins, dst, src)


def _extract(el, slot: int) -> list:
    from repro_torch.core import kvcache as kvc
    from repro_torch.core import paged
    if isinstance(el, SSMState):
        return [t[slot:slot + 1] for t in kvc.tree_leaves(el)]
    return paged.extract_slot(el, slot)


def extract_caches(caches: Any, slot: int) -> list:
    """One slot's complete state across the cache tree, the device half of a
    swap-out: each paged layer's `paged.extract_slot` and each SSM state's
    rows (1, ...), as one flat list of tensors (`restore_caches` takes it
    back)."""
    return [t for el in cache_elements(caches) for t in _extract(el, slot)]


def restore_caches(caches: Any, payload: list, slot: int) -> Any:
    """Inverse of `extract_caches`: paged layers through the slot's current
    table rows, SSM states as row writes."""
    from repro_torch.core import kvcache as kvc
    from repro_torch.core import paged

    def size(el) -> int:
        return len(dataclasses.fields(el)) if isinstance(el, SSMState) else paged.payload_len(el)

    if sum(size(el) for el in cache_elements(caches)) != len(payload):
        raise ValueError(f"a swap payload of {len(payload)} tensors does not fit the cache tree")
    rest = iter(payload)

    def rst(el):
        part = [next(rest) for _ in range(size(el))]
        if isinstance(el, SSMState):
            return kvc.tree_update_rows(el, SSMState(*part), slot)
        return paged.restore_slot(el, part, slot)

    return map_caches(rst, caches)


def copy_caches(caches: Any, moves) -> Any:
    """Apply one set of page moves ({segment: (src_ids, dst_ids)}) to every
    layer's pools, in place: the device half of copy-on-write.  Every layer
    shares the allocator's one table per segment, so one move set holds
    tree-wide.  SSM states hold no pages: they are left as they are."""
    from repro_torch.core import paged
    for el in cache_elements(caches):
        if not isinstance(el, SSMState):
            paged.copy_pages(el, moves)
    return caches


def free_caches(caches: Any, slot: int) -> Any:
    """Retire batch row `slot` across the cache tree (metadata row writes; a
    paged slot's pages stay, validity is pos-driven).  SSM states are left
    stale: the row is masked while the slot is inactive and overwritten by
    the next insertion."""
    from repro_torch.core import kvcache as kvc
    return map_caches(lambda el: el if isinstance(el, SSMState) else kvc.free_slot(el, slot),
                      caches)


def init_caches(cfg: ArchConfig, ctx: blocks.RunCtx, b: int, l_src: int = 0,
                dtype=torch.bfloat16, device="cuda"):
    """Empty caches; l_src: the encoder-decoder's source length (its cross
    caches' size)."""
    if cfg.encdec:
        return encdec.init_caches(cfg, ctx, b, l_src, dtype, device=device)
    return lm.init_caches(cfg, ctx, b, dtype, device=device)


def prefill_lengths(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[int, int]:
    """(decoder / query prefill length, encoder source length or 0).  The
    probes are built on the query length: the encoder-decoder's decoder
    prompt is min(128, seq_len) over a seq_len-frame source; a frontend
    arch's query holds its frontend tokens."""
    l = shape.seq_len
    if cfg.encdec:
        return min(128, l), l
    return l, 0
