"""Plain PyTorch version of the CSTQuant kernel (paper Alg. 1).

Same arithmetic as `core.quant.quantize_cst` at the kernel's granularity:
rows of tokens against a given per-slice channel scale.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant


def cst_quant_rows_ref(x: torch.Tensor, c: torch.Tensor, bits: int):
    """x (B, T, C) float, c (B, C) f32 -> (codes (B, T, C/pf) int8,
    token scale (B, T) f32, token zero (B, T) f32)."""
    xn = x.float() / c[:, None, :]
    scale, zero = quant._minmax_params(xn, bits, dim=-1)
    return quant._encode(xn, scale, zero, bits), scale[..., 0], zero[..., 0]
