"""Architecture and serving-shape configuration (copy of `repro.configs.base`,
cut to the dense decoder-only fields the port runs)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_scan_groups(self) -> int:
        """Stacked layer groups of the parameters: one layer per group."""
        return self.n_layers


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    cache_backend: str = "mixed"   # "mixed" | "paged"
    page_size: int = 64            # tokens per page ("paged" only)
    paged_kernel: bool = False     # "paged" only: decode attention walks the pages
    page_allocator: str = "static"  # "paged" only: "static" | "freelist"
    pool_fraction: float = 1.0     # "freelist" only: pools as a fraction of the worst case
    precision_map: str = ""        # per-layer/head effective-bit ceilings; "" = off
