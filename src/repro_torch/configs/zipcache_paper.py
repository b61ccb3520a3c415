"""The paper's own evaluation model family: LLaMA3-8B-shaped dense GQA.

ZipCache's tables use Mistral-7B / LLaMA2-7B/13B / LLaMA3-8B; this config is
the LLaMA3-8B shape (32L d_model=4096 32H GQA kv=8 d_ff=14336 vocab=128256),
used for the paper-faithful efficiency benchmarks (Fig. 6 / Table A).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zipcache-paper-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128_256,
    rope_theta=500_000.0,
)

SMOKE = ArchConfig(
    name="zipcache-paper-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
)
