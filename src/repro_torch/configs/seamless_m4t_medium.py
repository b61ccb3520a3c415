"""seamless-m4t-medium [audio] — enc-dec multimodal backbone [arXiv:2308.11596; hf].

12L d_model=1024 16H d_ff=4096 vocab=256206. The speech/audio frontend is a
stub: the engine takes precomputed frame embeddings (batch, frames,
d_model); the transformer backbone (12 enc + 12 dec with cross-attention)
is implemented fully.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                # decoder layers
    n_enc_layers=12,
    encdec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256_206,
    frontend="audio",
)

SMOKE = ArchConfig(
    name="seamless-m4t-medium-smoke",
    family="audio",
    n_layers=2,
    n_enc_layers=2,
    encdec=True,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    frontend="audio",
)
