"""Model API of the port (port of `repro.models.registry`, decoder-only)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, common, lm


def schema(cfg: ArchConfig) -> dict:
    return lm.lm_schema(cfg)


def materialize_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    return common.materialize(schema(cfg), seed, device=device)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, ctx: blocks.RunCtx):
    return lm.prefill(params, batch["tokens"], cfg, ctx)


def decode_step(params, token: torch.Tensor, caches: Any, cfg: ArchConfig,
                ctx: blocks.RunCtx, is_probe: bool):
    return lm.decode_step(params, token, caches, cfg, ctx, is_probe)


def recompress(caches: Any, cfg: ArchConfig, ctx: blocks.RunCtx):
    return lm.recompress_caches(caches, cfg, ctx)


def init_caches(cfg: ArchConfig, ctx: blocks.RunCtx, b: int, dtype=torch.bfloat16,
                device="cuda"):
    return lm.init_caches(cfg, ctx, b, dtype, device=device)
