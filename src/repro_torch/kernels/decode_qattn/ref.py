"""Plain PyTorch version of quantized-cache decode attention.

Dequantizes a packed store segment (rounding to the store dtype, as
`QuantizedTensor.dequantize` does) and runs one-token attention, returning
flash-decoding merge stats (acc, m, l) so segments combine as the kernel's do.
`mixed_layer_ref` is the layer kernel's function: every segment of a decode
layer (hi, lo, raw window) merged once into the normalized output.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core import packing

NEG_INF = -1e30


def dequant_k_ref(k_codes, k_scale, k_zero, bits: int) -> torch.Tensor:
    """Channelwise K dequant, rounded to the store dtype: (b,hk,S,d) f32."""
    x = packing.unpack(k_codes, bits, torch.float32)
    return ((x - k_zero.float()) * k_scale.float()).to(k_scale.dtype).float()


def dequant_v_ref(v_codes, v_cscale, v_tscale, v_tzero, bits: int) -> torch.Tensor:
    """CST V dequant, rounded to the store dtype: (b,hk,S,dv) f32."""
    x = packing.unpack(v_codes, bits, torch.float32)
    x = (x - v_tzero.float()) * v_tscale.float()
    return (x * v_cscale.float()).to(v_tscale.dtype).float()


def segment_attend_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor, scale: float):
    """Unnormalized one-token attention over one segment.

    q (b,h,d), k (b,hk,S,d) f32, v (b,hk,S,dv) f32, valid (b,S).
    Returns (acc (b,h,dv) f32, m (b,h), l (b,h))."""
    b, h, d = q.shape
    hk = k.shape[1]
    g = h // hk
    qg = q.reshape(b, hk, g, d).float() * scale
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k)
    vm = valid[:, None, None, :]
    s = s.masked_fill(~vm, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill(~vm, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bhsv->bhgv", p, v)
    return acc.reshape(b, h, -1), m.reshape(b, h), l.reshape(b, h)


def merge_segments_ref(stats: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]):
    """Combine [(acc, m, l), ...] -> normalized out (b, h, dv) f32."""
    m_all = torch.stack([s[1] for s in stats], 0).amax(dim=0)
    out = 0.0
    l_all = 0.0
    for acc, mi, li in stats:
        w = torch.exp(mi - m_all)
        out = out + acc * w[..., None]
        l_all = l_all + li * w
    return out / l_all.clamp_min(1e-30)[..., None]


def qattn_segment_ref(q, k_codes, k_scale, k_zero, v_codes, v_cscale, v_tscale, v_tzero,
                      pos, k_bits: int, v_bits: int):
    """The kernel's function: attention stats over one packed store."""
    k = dequant_k_ref(k_codes, k_scale, k_zero, k_bits)
    v = dequant_v_ref(v_codes, v_cscale, v_tscale, v_tzero, v_bits)
    return segment_attend_ref(q, k, v, pos >= 0, 1.0 / (q.shape[-1] ** 0.5))


def mixed_layer_ref(q: torch.Tensor, segments) -> torch.Tensor:
    """The layer kernel's function over one to three segments in walk order
    (the operands of `kernel.qattn_mixed_layer`): raw segments (bits >= 16)
    pass their values through, quantized ones dequantize as the store does.
    Returns out (b, h, dv) in q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    stats = []
    for sg in segments:
        if sg["k_bits"] >= 16:
            k, v = sg["k_codes"].float(), sg["v_codes"].float()
        else:
            k = dequant_k_ref(sg["k_codes"], sg["k_scale"], sg["k_zero"], sg["k_bits"])
            v = dequant_v_ref(sg["v_codes"], sg["v_cscale"], sg["v_tscale"], sg["v_tzero"],
                              sg["v_bits"])
        stats.append(segment_attend_ref(q, k, v, sg["pos"] >= 0, scale))
    return merge_segments_ref(stats).to(q.dtype)
