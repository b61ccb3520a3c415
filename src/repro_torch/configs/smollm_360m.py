"""smollm-360m [dense] — small llama-arch [hf:HuggingFaceTB/SmolLM-360M; hf].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49_152,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="smollm-360m-smoke",
    family="dense",
    n_layers=2,
    d_model=60,     # keeps the non-power-of-two flavour (15 heads -> 4 here)
    n_heads=3,
    n_kv_heads=1,
    d_ff=128,
    vocab=256,
    tie_embeddings=True,
)
