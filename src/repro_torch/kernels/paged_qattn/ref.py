"""Plain PyTorch version of paged quantized-cache decode attention (port of
`repro.kernels.paged_qattn.ref`).

Walks a slot's page table, dequantizes each page with the dense per-slot
parameters (rounding to the store dtype, as `QuantizedTensor.dequantize`
does) and computes one-token attention stats.  `merge_segments_weights` is
the flash-decoding combiner of the per-segment path; `paged_layer_ref` is
the layer kernel's function: every segment of a decode layer, each masked
at its valid length (no padded operands), merged once.
Raw segments (bits >= 16: the bf16 staging window, fp16 stores) hold values,
not codes; their parameters are ignored and may be None.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import packing

NEG_INF = -1e30


def dequant_page_ref(codes, bits, scale_t, zero_t, scale_c, zero_c, channel_scale,
                     dtype=torch.float32) -> torch.Tensor:
    """Dequantize page codes (..., page, c_packed) -> (..., page, d) f32.
    Exactly one of the tokenwise (scale_t, zero_t) and channelwise
    (scale_c, zero_c) pairs is given; channel_scale is CST's normalizer or
    None.  `dtype` is the store dtype the result rounds to."""
    if bits >= 16:
        return codes.float()
    x = packing.unpack(codes, bits, torch.float32)
    if scale_c is not None:
        x = (x - zero_c.float()) * scale_c.float()
    else:
        x = (x - zero_t.float()) * scale_t.float()
    if channel_scale is not None:
        x = x * channel_scale.float()
    return x.to(dtype).float()


def segment_stats_ref(q, k, v, valid, scale: float):
    """Unnormalized one-token attention over one segment.

    q (b,h,d), k (b,hk,S,d) f32, v (b,hk,S,dv) f32, valid (b,S).
    Returns (acc (b,h,dv), m (b,h), l (b,h), p (b,h,S)), `p` relative to m."""
    b, h, d = q.shape
    hk = k.shape[1]
    qg = q.reshape(b, hk, h // hk, d).float() * scale
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k)
    vm = valid[:, None, None, :]
    s = s.masked_fill(~vm, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill(~vm, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bhsv->bhgv", p, v)
    return acc.reshape(b, h, -1), m.reshape(b, h), l.reshape(b, h), p.reshape(b, h, -1)


def merge_segments_weights(stats: Sequence[Tuple]) -> Tuple[torch.Tensor, Optional[List]]:
    """Flash-decoding merge of [(acc, m, l, p-relative-to-m or None), ...].

    Returns (out (b,h,dv) f32 normalized, [w_seg (b,h,S_seg), ...] or None
    when the segments carry no `p`).  A row with no valid slot anywhere
    gives zeros (l = 0; the division takes max(l, 1e-30))."""
    m_all = torch.stack([s[1] for s in stats], 0).amax(dim=0)
    out = 0.0
    l_all = 0.0
    for acc, mi, li, _ in stats:
        w = torch.exp(mi - m_all)
        out = out + acc * w[..., None]
        l_all = l_all + li * w
    denom = l_all.clamp_min(1e-30)
    if any(s[3] is None for s in stats):
        return out / denom[..., None], None
    weights = [p * (torch.exp(mi - m_all) / denom)[..., None] for _, mi, _, p in stats]
    return out / denom[..., None], weights


def gather_pages_ref(pages: torch.Tensor, table: torch.Tensor, capacity: int) -> torch.Tensor:
    """(P,hk,page,c) via table (b,npp) -> (b,hk,capacity,c) in logical order."""
    g = pages[table.long()].transpose(1, 2)             # (b, hk, npp, page, c)
    return g.reshape(g.shape[0], g.shape[1], -1, g.shape[-1])[:, :, :capacity]


def paged_segment_ref(q, k_pages, k_scale, k_zero, v_pages, v_cscale, v_tscale, v_tzero, pos,
                      table, *, k_bits: int, v_bits: int, scale: float,
                      k_dtype=torch.float32, v_dtype=torch.float32):
    """The kernel's function: dequantize page by page in logical order (each
    page with its slice of the dense parameters), then the segment stats.
    Metadata (pos, v_tscale, v_tzero) is padded to S_pad = npp * page."""
    page = k_pages.shape[2]
    k_parts, v_parts = [], []
    for j in range(table.shape[1]):
        idx = table[:, j].long()
        sl = slice(j * page, (j + 1) * page)
        k_parts.append(dequant_page_ref(k_pages[idx], k_bits, None, None, k_scale, k_zero, None,
                                        dtype=k_dtype))
        v_parts.append(dequant_page_ref(
            v_pages[idx], v_bits, None if v_tscale is None else v_tscale[:, :, sl],
            None if v_tzero is None else v_tzero[:, :, sl], None, None, v_cscale, dtype=v_dtype))
    return segment_stats_ref(q, torch.cat(k_parts, dim=2), torch.cat(v_parts, dim=2), pos >= 0,
                             scale)


def paged_layer_ref(q, segments, *, scale: float):
    """The layer kernel's function over one to three segments in walk order.

    Each segment dict holds the operands of `paged_segment_ref` (keys as its
    arguments, plus k_bits / v_bits / k_dtype / v_dtype), with pos
    (b, s_seg) and the V token parameters (b, hk, s_seg, 1) unpadded: the
    walk reads the first s_seg slots of the table's pages and no further.
    Returns (out (b,h,dv) in q's dtype, normalized; m (b,h); l (b,h);
    p (b,h,sum s_seg) relative to m, over the concatenated slots)."""
    stats = []
    for sg in segments:
        s_seg = sg["pos"].shape[-1]
        k = dequant_page_ref(gather_pages_ref(sg["k_pages"], sg["table"], s_seg), sg["k_bits"],
                             None, None, sg["k_scale"], sg["k_zero"], None, dtype=sg["k_dtype"])
        v = dequant_page_ref(gather_pages_ref(sg["v_pages"], sg["table"], s_seg), sg["v_bits"],
                             sg["v_tscale"], sg["v_tzero"], None, None, sg["v_cscale"],
                             dtype=sg["v_dtype"])
        stats.append(segment_stats_ref(q, k, v, sg["pos"] >= 0, scale))
    m = torch.stack([st[1] for st in stats], 0).amax(dim=0)
    acc = 0.0
    l = 0.0
    ps = []
    for acc_i, m_i, l_i, p_i in stats:
        w = torch.exp(m_i - m)
        acc = acc + acc_i * w[..., None]
        l = l + l_i * w
        ps.append(p_i * w[..., None])
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype), m, l, torch.cat(ps, dim=-1)
