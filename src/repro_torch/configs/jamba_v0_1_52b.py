"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE [arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
HF config: attn_layer_period=8, attn_layer_offset=4, expert_layer_period=2,
expert_layer_offset=1; mamba d_state=16, d_conv=4, expand=2.  One scan
group is 8 layers (layer 4 attention, odd layers MoE).  A copy of
`repro.configs.jamba_v0_1_52b`.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    moe_layer_offset=1,
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_n_groups=1,
)

SMOKE = ArchConfig(
    name="jamba-v0.1-52b-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    n_experts=4,
    top_k=2,
    moe_d_ff=128,
    moe_layer_period=2,
    moe_layer_offset=1,
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=32,
    ssm_n_groups=1,
)
