"""llava-next-34b [vlm] — yi-34b backbone + anyres vision stub
[hf:llava-hf/llava-v1.6-34b-hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. The anyres vision
tower is a stub: the engine takes precomputed patch embeddings (batch,
n_patches, d_model), projected and prepended to the text sequence.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64_000,
    rope_theta=5_000_000.0,
    frontend="vision",
    n_frontend_tokens=576,   # one 24x24 CLIP tile; anyres adds tiles upstream
)

SMOKE = ArchConfig(
    name="llava-next-34b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    frontend="vision",
    n_frontend_tokens=16,
)
