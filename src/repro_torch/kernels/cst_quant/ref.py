"""Plain PyTorch versions of the cache-store quantization kernel.

`quantize_store_ref` is what one `quantize_store` launch computes: the
gather of a store's tokens (zero rows where the slot index is -1), then
`core.quant.quantize_channelwise` for K and `quantize_cst` for V.  The
reference's two oracles (`repro.kernels.cst_quant.ref`) come with it:
`cst_quantize_ref` and `cst_dequantize_ref`; `cst_quant_rows_ref` is the
TPU kernel's granularity, rows against a given per-slice channel scale.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing, quant
from repro_torch.core.kvcache import _gather_tokens


def cst_quantize_ref(x: torch.Tensor, bits: int, channel_scale: torch.Tensor = None):
    """x (..., T, C) float -> (codes (..., T, C/pf) int8, token scale (..., T, 1)
    f32, token zero (..., T, 1) f32, channel scale (..., 1, C) f32); c is
    sqrt(max(colmax|x|, eps)) unless given."""
    xf = x.float()
    c = quant.channel_norm_scale(xf) if channel_scale is None else channel_scale.float()
    xn = xf / c
    scale, zero = quant._minmax_params(xn, bits, dim=-1)
    return quant._encode(xn, scale, zero, bits), scale, zero, c


def cst_dequantize_ref(codes, scale, zero, c, bits: int, out_dtype=torch.float32):
    q = packing.unpack(codes, bits, out_dtype=torch.float32)
    return ((q - zero) * scale * c).to(out_dtype)


def cst_quant_rows_ref(x: torch.Tensor, c: torch.Tensor, bits: int):
    """x (B, T, C) float, c (B, C) f32 -> (codes (B, T, C/pf) int8,
    token scale (B, T) f32, token zero (B, T) f32)."""
    codes, scale, zero, _ = cst_quantize_ref(x, bits, c[:, None, :])
    return codes, scale[..., 0], zero[..., 0]


def quantize_store_ref(k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor, bits: int,
                       eff: torch.Tensor = None):
    """k (b, hk, l, dk), v (b, hk, l, dv), idx (b, S) int32 (-1 = a zero row),
    eff optional (b, hk, 2) f32 effective bits of K and V -> (k_codes,
    k_scale, k_zero, v_codes, v_scale, v_zero, v_cscale), the parameters in
    the sources' dtype."""
    eff_k = eff_v = None
    if eff is not None:
        eff_k, eff_v = eff[..., 0, None, None], eff[..., 1, None, None]
    qk = quant.quantize_channelwise(_gather_tokens(k, idx), bits, eff=eff_k)
    qv = quant.quantize_cst(_gather_tokens(v, idx), bits, eff=eff_v)
    return qk.codes, qk.scale, qk.zero, qv.codes, qv.scale, qv.zero, qv.channel_scale
