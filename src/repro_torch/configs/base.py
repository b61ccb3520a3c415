"""Architecture and serving-shape configuration (copy of `repro.configs.base`,
cut to the decoder-only fields the port runs: dense, MoE, MLA, and the SSM
and hybrid layers (mamba2, Jamba); the encoder-decoder and frontend fields
are left out)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm
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

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    moe_layer_period: int = 1    # layer i is MoE iff i % period == offset
    moe_layer_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- MLA (deepseek-v2) ---
    mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / hybrid ---
    attn_layer_period: int = 0   # 0 => all layers attention (or all ssm if ssm=True)
    attn_layer_offset: int = 0
    ssm: bool = False            # True => attention-free (mamba2)
    ssm_d_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_n_groups: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.first_dense_layers:
            return False
        return (i % self.moe_layer_period) == self.moe_layer_offset

    def is_attn_layer(self, i: int) -> bool:
        if self.ssm:
            return False
        if self.attn_layer_period == 0:
            return True
        return (i % self.attn_layer_period) == self.attn_layer_offset

    @property
    def scan_group(self) -> int:
        """Layers per stacked group (homogeneous across groups): the lcm of
        the attention and MoE periods (8 for Jamba)."""
        g = self.attn_layer_period or 1
        if self.n_experts and self.moe_layer_period > 1:
            g = math.lcm(g, self.moe_layer_period)
        return g

    @property
    def n_scan_groups(self) -> int:
        """Stacked layer groups after the unrolled prefix (first dense) layers."""
        body = self.n_layers - self.first_dense_layers
        assert body % self.scan_group == 0, (self.name, body, self.scan_group)
        return body // self.scan_group

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """Per-layer (mixer, ffn) kinds within one group (group-invariant)."""
        kinds = []
        for j in range(self.scan_group):
            i = self.first_dense_layers + j  # kinds are periodic: group 0 stands for all
            if self.ssm or not self.is_attn_layer(i):
                mixer = "ssm"
            else:
                mixer = "mla" if self.mla else "attn"
            ffn = "moe" if self.is_moe_layer(i) else ("dense" if self.d_ff else "none")
            kinds.append((mixer, ffn))
        return tuple(kinds)

    def validate_periodicity(self) -> None:
        """The layer-kind pattern must repeat exactly every scan_group layers."""
        base = self.first_dense_layers
        for i in range(base, self.n_layers):
            j = base + (i - base) % self.scan_group
            a = (self.is_attn_layer(i), self.is_moe_layer(i))
            b = (self.is_attn_layer(j), self.is_moe_layer(j))
            assert a == b, f"{self.name}: layer {i} kind differs from group pattern"

    def prefix_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, ffn) of each unrolled prefix layer: dense FFN."""
        return (("mla" if self.mla else "attn", "dense"),) * self.first_dense_layers


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
