"""deepseek-moe-16b [moe] — fine-grained MoE, GQA(=MHA kv=16) [arXiv:2401.06066; hf].

28L d_model=2048 16H d_ff(moe)=1408 vocab=102400; 2 shared + 64 routed top-6;
first layer dense (intermediate_size=10944).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab=102_400,
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    n_shared_experts=2,
    first_dense_layers=1,
)

SMOKE = ArchConfig(
    name="deepseek-moe-16b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    n_experts=4,
    top_k=2,
    moe_d_ff=32,
    n_shared_experts=1,
    first_dense_layers=1,
)
