"""Architecture registry of the port: every architecture of the reference's
registry (`--arch <id>`), each config a copy of the reference's."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "yi-6b": "repro_torch.configs.yi_6b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "zipcache-paper-8b": "repro_torch.configs.zipcache_paper",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
}


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    cfg = mod.SMOKE if smoke else mod.CONFIG
    cfg.validate_periodicity()
    return cfg
