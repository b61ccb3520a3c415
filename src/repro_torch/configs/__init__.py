"""Architecture registry of the port (the architectures ported so far)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "yi-6b": "repro_torch.configs.yi_6b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
}


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG
