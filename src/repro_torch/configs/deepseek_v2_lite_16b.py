"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff(moe)=1408 vocab=102400, 2 shared + 64 routed top-6,
MLA kv_lora_rank=512, no q lora.  First layer dense (HF
first_k_dense_replace=1, intermediate_size=10944).  A copy of
`repro.configs.deepseek_v2_lite_16b`.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                # dense layers (layer 0)
    vocab=102_400,
    mla=True,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    head_dim=192,              # nope + rope
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    n_shared_experts=2,
    first_dense_layers=1,
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-16b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    mla=True,
    kv_lora_rank=32,
    rope_head_dim=16,
    nope_head_dim=16,
    v_head_dim=16,
    head_dim=32,
    n_experts=4,
    top_k=2,
    moe_d_ff=32,
    n_shared_experts=1,
    first_dense_layers=1,
)
