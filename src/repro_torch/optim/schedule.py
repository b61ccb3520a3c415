"""LR schedules (port of `repro.optim.schedule`): f32 functions of an int
step tensor, each division a true one (`quant.true_div`)."""

from __future__ import annotations

import math

import torch

from repro_torch.core.quant import true_div


def linear_warmup(warmup_steps: int):
    def fn(step: torch.Tensor) -> torch.Tensor:
        return true_div(step.float(), max(warmup_steps, 1)).clamp_max(1.0)
    return fn


def cosine_schedule(warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = true_div(s, max(warmup_steps, 1)).clamp_max(1.0)
        prog = true_div(s - warmup_steps, max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
        cos = final_frac + (1.0 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return warm * cos
    return fn
