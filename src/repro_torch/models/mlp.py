"""Dense SwiGLU FFN (port of `repro.models.mlp.dense_mlp`)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models.common import ParamDef


def dense_mlp_schema(cfg: ArchConfig, d_ff: Optional[int] = None) -> dict:
    e, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_gate": ParamDef((e, f)), "w_up": ParamDef((e, f)), "w_down": ParamDef((f, e))}


def dense_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    return common.swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
