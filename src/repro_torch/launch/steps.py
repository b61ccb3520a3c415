"""Serving context and the engines' step functions (port of the serving half
of `repro.launch.steps`).

The JAX package builds each engine program with a step factory and jits
it; PyTorch runs eagerly, so the factories become the plain functions
below, called with the serving context they share.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import backend as backend_lib
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.models import blocks, registry


def serve_ctx(cfg: ArchConfig, shape: ShapeConfig, ccfg: Optional[CompressionConfig] = None,
              decode_budget: int = 512, q_block: int = 512, device="cuda",
              use_kernels: bool = True) -> blocks.RunCtx:
    """RunCtx + probes for a serving shape; max cache = seq_len + decode budget.

    The shape carries the cache layout (`cache_backend`, `page_size`,
    `paged_kernel`, `page_allocator`, `pool_fraction`).  use_kernels: the
    port's CUDA kernels on the path (the default), or their plain PyTorch
    versions throughout.
    """
    ccfg = ccfg or CompressionConfig.zipcache()
    qlen = shape.seq_len
    probe = None
    if ccfg.uses_saliency and ccfg.probe_strategy not in ("none", "exact"):
        probe = sal.select_probes(qlen, ccfg.probe_strategy, ccfg.probe_ratio, ccfg.seed,
                                  device=device)
    if ccfg.needs_full_attention:
        probe = sal.select_probes(qlen, "all", 1.0, device=device)
    backend = backend_lib.of(ccfg, kind=shape.cache_backend, use_kernels=use_kernels,
                             page_size=shape.page_size, paged_kernel=shape.paged_kernel,
                             page_allocator=shape.page_allocator,
                             pool_fraction=shape.pool_fraction)
    return blocks.RunCtx(ccfg=ccfg, probe=probe, max_cache_len=shape.seq_len + decode_budget,
                         q_block=q_block, use_kernels=use_kernels, backend=backend)


def continuous_decode(params, caches: Any, token: torch.Tensor, probes, active: torch.Tensor,
                      cfg: ArchConfig, ctx: blocks.RunCtx):
    """Decode with per-slot probe flags and an active-slot mask -> (logits,
    caches).  Inactive slots are masked (no append, invalid positions), never
    sliced away."""
    return registry.decode_step(params, token, caches, cfg, ctx, probes, active=active)


def insert(caches: Any, slice_caches: Any, slot: int):
    """Write a batch-1 prefill cache slice into decode-batch row `slot`."""
    return registry.insert_caches(caches, slice_caches, slot)


def recompress_rows(caches: Any, rows: torch.Tensor, cfg: ArchConfig, ctx: blocks.RunCtx):
    """Fold the staging windows of the masked slots only (per-request cadence,
    paper Alg. 3).  Recompresses the whole batch and selects rows."""
    return registry.recompress(caches, cfg, ctx, rows=rows)


def recompress_slot(caches: Any, slot: int, cfg: ArchConfig, ctx: blocks.RunCtx):
    """Fold exactly ONE slot's staging window through the backend's per-slot
    recompression (the paged layout): a batch-1 view, ~1/slots the work."""
    return registry.recompress(caches, cfg, ctx, slot=slot)
