"""The cache-store quantization kernel as the cache calls it.

`quantize_store` wraps one `kernel.quantize_store` launch into the two
`QuantizedTensor`s of a store, with a store's effective bits (K's and V's,
each broadcastable to (b, hk, 1, 1)) as the kernel's (b, hk, 2) table.  `cst_quantize` mirrors the reference's
`ops.cst_quantize` (the channel scale in torch, the rows through the
kernel, f32 params).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.kernels.cst_quant import kernel as K

EPS = 1e-8


def eff_table(eff_k: torch.Tensor, eff_v: torch.Tensor, b: int, hk: int) -> torch.Tensor:
    """(b, hk, 2) f32 effective bits of K and V."""
    return torch.stack([torch.broadcast_to(e.float(), (b, hk, 1, 1))[..., 0, 0]
                        for e in (eff_k, eff_v)], dim=-1).contiguous()


def quantize_store(k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor, bits: int,
                   eff: Optional[Tuple] = None
                   ) -> Tuple[quant.QuantizedTensor, quant.QuantizedTensor]:
    """The (K channelwise, V CST) store of the tokens idx (b, S) picks from
    k / v (b, hk, l, d), -1 giving a zero row; one launch.  eff: None or
    (eff_k, eff_v), the store's effective bits."""
    b, hk, _, dk = k.shape
    table = None if eff is None else eff_table(*eff, b, hk)
    kc, ks, kz, vc, vs, vz, vcs = K.quantize_store(k, v, idx, bits, eff=table)
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
