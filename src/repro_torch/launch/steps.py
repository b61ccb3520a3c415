"""Serving context (port of `repro.launch.steps.serve_ctx`, mixed layout)."""

from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import backend as backend_lib
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.models import blocks


def serve_ctx(cfg: ArchConfig, shape: ShapeConfig, ccfg: Optional[CompressionConfig] = None,
              decode_budget: int = 512, q_block: int = 512, device="cuda",
              use_kernels: bool = True) -> blocks.RunCtx:
    """RunCtx + probes for a serving shape; max cache = seq_len + decode budget.

    use_kernels: the port's CUDA kernels on the path (the default), or the
    plain PyTorch path throughout (the reference's live numerics).
    """
    ccfg = ccfg or CompressionConfig.zipcache()
    qlen = shape.seq_len
    probe = None
    if ccfg.uses_saliency and ccfg.probe_strategy not in ("none", "exact"):
        probe = sal.select_probes(qlen, ccfg.probe_strategy, ccfg.probe_ratio, ccfg.seed,
                                  device=device)
    if ccfg.needs_full_attention:
        probe = sal.select_probes(qlen, "all", 1.0, device=device)
    backend = backend_lib.of(ccfg, kind=shape.cache_backend, use_kernels=use_kernels)
    return blocks.RunCtx(ccfg=ccfg, probe=probe, max_cache_len=shape.seq_len + decode_budget,
                         q_block=q_block, use_kernels=use_kernels, backend=backend)
