"""Launch wrapper of the CSTQuant kernel (`csrc/cst_quant.cu`).

Replaces `src/repro/kernels/cst_quant/kernel.py::cst_quantize_pallas`.
Bound on the H100: bytes (read x once, write bits/8 of it back).  One warp
per token row: shuffle min/max, pack in registers, one store per byte.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cst_quant import ref

LIB = build.CudaLibrary("cst_quant")
KERNEL = build.CudaKernel(LIB, "cst_quant_launch", [build.P] * 5 + [build.I] * 5 + [build.P])


def cst_quant_rows(x: torch.Tensor, c: torch.Tensor, bits: int):
    """x (B, T, C) bf16/f32, c (B, C) f32 -> (codes (B, T, C/pf) int8,
    scale (B, T) f32, zero (B, T) f32).  CPU tensors take `ref`."""
    if x.device.type == "cpu":
        return ref.cst_quant_rows_ref(x, c, bits)
    if x.device.type != "cuda":
        raise ValueError(f"cst_quant: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 3:
        raise ValueError(f"cst_quant: x must be (B, T, C) bf16/f32, got {x.dtype} {tuple(x.shape)}")
    bsz, t, ch = x.shape
    if bits not in (2, 4) or ch % (8 // bits):
        raise ValueError(f"cst_quant: bits {bits} with {ch} channels")
    if c.shape != (bsz, ch) or c.dtype != torch.float32 or c.device != x.device:
        raise ValueError(f"cst_quant: channel scale must be ({bsz}, {ch}) f32 on {x.device}")
    x = x.contiguous()
    c = c.contiguous()
    codes = torch.empty((bsz, t, ch // (8 // bits)), dtype=torch.int8, device=x.device)
    scale = torch.empty((bsz, t), dtype=torch.float32, device=x.device)
    zero = torch.empty((bsz, t), dtype=torch.float32, device=x.device)
    if t:
        KERNEL(build.ptr(x), build.ptr(c), build.ptr(codes), build.ptr(scale), build.ptr(zero),
               bsz * t, t, ch, bits, int(x.dtype == torch.bfloat16), build.stream_of(x))
    return codes, scale, zero
