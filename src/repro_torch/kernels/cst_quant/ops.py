"""CSTQuant over (..., T, C): channel scales outside the kernel, batching.

`cst_quantize` mirrors the reference's `ops.cst_quantize` (f32 params);
`quantize_cst` is the drop-in for `core.quant.quantize_cst` on the cache's
path: it casts scale, zero and c to the store dtype, as the core does.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels.cst_quant import kernel as K

EPS = 1e-8


def cst_quantize(x: torch.Tensor, bits: int):
    """Fused CSTQuant over (..., T, C).  Returns (codes (..., T, C/pf) int8,
    token_scale (..., T, 1) f32, token_zero (..., T, 1) f32,
    channel_scale (..., 1, C) f32).

    The channel scale c = sqrt(max(colmax|x|, eps)) is one column reduce
    over the whole token axis, padding rows included, as in the core.
    """
    *lead, t, ch = x.shape
    xf = x.reshape(-1, t, ch)
    cs = quant.correctly_rounded_sqrt(xf.float().abs().amax(dim=1).clamp_min(EPS))  # (B, C)
    codes, scale, zero = K.cst_quant_rows(xf, cs, bits)
    pf = 8 // bits
    return (codes.reshape(*lead, t, ch // pf), scale.reshape(*lead, t, 1),
            zero.reshape(*lead, t, 1), cs.reshape(*lead, 1, ch))


def quantize_cst(x: torch.Tensor, bits: int) -> quant.QuantizedTensor:
    """`core.quant.quantize_cst(x, bits)` through the kernel: same codes,
    same store-dtype parameters."""
    codes, scale, zero, cs = cst_quantize(x, bits)
    return quant.QuantizedTensor(codes, scale.to(x.dtype), zero.to(x.dtype), cs.to(x.dtype),
                                 bits, tuple(x.shape))
