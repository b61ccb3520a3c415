"""Architecture registry of the port (the architectures ported so far)."""

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
}


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    cfg = mod.SMOKE if smoke else mod.CONFIG
    cfg.validate_periodicity()
    return cfg
