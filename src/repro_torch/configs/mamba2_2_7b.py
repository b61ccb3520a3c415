"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free [arXiv:2405.21060].

64L d_model=2560, ssm_state=128, head_dim=64 (expand=2 -> d_inner=5120,
80 SSD heads), vocab=50280.  No attention layer, so no KV cache for ZipCache
to compress: every layer's cache element is its recurrent state.  A copy of
`repro.configs.mamba2_2_7b`.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,              # attn-free, MLP-free: the mamba mixer IS the block
    vocab=50_280,
    ssm=True,
    ssm_d_state=128,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_n_groups=1,
)

SMOKE = ArchConfig(
    name="mamba2-2.7b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=256,
    ssm=True,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=32,
    ssm_n_groups=1,
)
