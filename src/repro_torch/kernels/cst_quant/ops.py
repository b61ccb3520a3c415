"""The cache-store quantization kernel as the cache calls it.

`quantize_store` wraps one `kernel.quantize_store` launch into the two
`QuantizedTensor`s of a store.  `cst_quantize` mirrors the reference's
`ops.cst_quantize` (the channel scale in torch, the rows through the
kernel, f32 params).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import quant
from repro_torch.kernels.cst_quant import kernel as K

EPS = 1e-8


def quantize_store(k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
                   bits: int) -> Tuple[quant.QuantizedTensor, quant.QuantizedTensor]:
    """The (K channelwise, V CST) store of the tokens idx (b, S) picks from
    k / v (b, hk, l, d), -1 giving a zero row; one launch."""
    kc, ks, kz, vc, vs, vz, vcs = K.quantize_store(k, v, idx, bits)
    b, hk, _, dk = k.shape
    s = idx.shape[1]
    return (quant.QuantizedTensor(kc, ks, kz, None, bits, (b, hk, s, dk)),
            quant.QuantizedTensor(vc, vs, vz, vcs, bits, (b, hk, s, v.shape[-1])))


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
