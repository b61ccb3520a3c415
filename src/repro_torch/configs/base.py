"""Architecture and serving-shape configuration (copy of `repro.configs.base`,
cut to the fields the port runs: dense, MoE, MLA, the SSM and hybrid layers
(mamba2, Jamba), the encoder-decoder (seamless-m4t) and the modality
frontend stubs (llava's vision, seamless's audio projections); the MLA
query low-rank field, 0 in every config ported, and the shape tables of
the training and dry-run launchers are left out)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
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

    # --- encoder-decoder ---
    encdec: bool = False
    n_enc_layers: int = 0

    # --- modality frontend stubs ---
    frontend: str = "none"       # none | audio | vision
    n_frontend_tokens: int = 0

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

    def param_count(self) -> int:
        """Approximate total parameters (embeddings + blocks), as the
        reference counts them (the encoder-decoder's term included)."""
        e = self.d_model
        n = self.vocab * e * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            if self.ssm or not self.is_attn_layer(i):
                d_in = self.ssm_expand * e
                heads = d_in // self.ssm_head_dim
                n += e * (2 * d_in + 2 * self.ssm_n_groups * self.ssm_d_state + heads)
                n += d_in * self.ssm_d_conv + d_in * e + heads
            elif self.mla:
                n += e * (self.kv_lora_rank + self.rope_head_dim)
                n += e * self.n_heads * (self.nope_head_dim + self.rope_head_dim)
                n += self.kv_lora_rank * self.n_heads * (self.nope_head_dim + self.v_head_dim)
                n += self.n_heads * self.v_head_dim * e
            else:
                n += e * self.hd * (self.n_heads * 2 + self.n_kv_heads * 2)
            if self.is_moe_layer(i):
                n += self.n_experts * 3 * e * self.moe_d_ff
                n += self.n_shared_experts * 3 * e * self.moe_d_ff
                n += e * self.n_experts
            elif self.d_ff:
                n += 3 * e * self.d_ff
        if self.encdec:
            # encoder blocks and the decoder's cross-attention (the
            # reference's rough term: a same-size encoder)
            n += self.n_enc_layers * (4 * e * e + 3 * e * self.d_ff)
            n += self.n_layers * 4 * e * e
        return n


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
