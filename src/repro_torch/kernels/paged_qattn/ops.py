"""Paged decode attention over a `PagedKVCache`, pages read in place (port of
`repro.kernels.paged_qattn.ops`).

`attend_paged` replaces the paged backend's gather path
(`kvcache.attend_decode(q, cache.dense_view())`) wherever the stores carry
channelwise K / CST V codes or raw >= 16-bit values (the ZipCache, fp16 and
H2O configurations): the hi store, the lo store and the bf16 staging window go
through one `kernel.qattn_paged_layer` call, which walks the three segments'
pages and merges their flash stats as `ref.merge_segments_weights` does.
With `want_weights` it also rebuilds the head-pooled slot weights; the
engine asks for them only where it uses them (the reference's probe steps
take them from the gather path instead).

Rows with no valid slot give zeros, where the dense softmax gives a uniform
average over garbage; such rows are empty slots, masked by every consumer.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import kvcache as kvc
from repro_torch.kernels import qattn_walk as walk
from repro_torch.kernels.paged_qattn import kernel as K
from repro_torch.kernels.paged_qattn import ref as R


def kernel_supported(cache) -> bool:
    """Static check of the stores: every non-empty one must be in the walk's
    schemes (`qattn_walk.store_supported`: channelwise K, CST V, or raw).
    Groupwise / tokenwise stores (KIVI, GEAR) take the gather path."""
    return all(walk.store_supported(s.k_meta, s.v_meta)
               for s in (cache.hi, cache.lo) if s.table.shape[1])


def _store_operands(store, pad: bool = False) -> dict:
    """Kernel operands of a quantized or raw `PagedStore` segment.  Raw
    halves pass no parameters; quantized ones round to their store dtype.
    `pad`: pos (-1) and the V token parameters (0) padded to npp * page, as
    the per-segment path takes them; the layer kernel masks at s_seg."""
    km, vm = store.k_meta, store.v_meta
    s_pad = store.table.shape[1] * store.k_pages.shape[2] if pad else store.capacity
    ops = dict(k_pages=store.k_pages, v_pages=store.v_pages, pos=_pad(store.pos, s_pad, -1),
               table=store.table, k_bits=km.bits, v_bits=vm.bits, s_seg=store.capacity,
               k_scale=None, k_zero=None, v_cscale=None, v_tscale=None, v_tzero=None,
               k_dtype=torch.float32, v_dtype=torch.float32)
    if km.bits < 16:
        ops.update(k_scale=km.scale, k_zero=km.zero, k_dtype=km.scale.dtype)
    if vm.bits < 16:
        ops.update(v_cscale=vm.channel_scale, v_tscale=_pad(vm.scale, s_pad, 0, dim=-2),
                   v_tzero=_pad(vm.zero, s_pad, 0, dim=-2), v_dtype=vm.scale.dtype)
    return ops


def _window_operands(cache, pad: bool = False) -> dict:
    """Kernel operands of the raw staging-window segment."""
    s_pad = cache.win_table.shape[1] * cache.page_size if pad else cache.window
    return dict(k_pages=cache.win_k_pages, v_pages=cache.win_v_pages,
                pos=_pad(cache.win_pos, s_pad, -1), table=cache.win_table, k_bits=16, v_bits=16,
                s_seg=cache.window, k_scale=None, k_zero=None, v_cscale=None, v_tscale=None,
                v_tzero=None, k_dtype=torch.float32, v_dtype=torch.float32)


def _pad(x: torch.Tensor, size: int, value, dim: int = -1) -> torch.Tensor:
    """x with axis `dim` (the tokens) padded to `size`; x itself when it fits."""
    n = x.shape[dim]
    if n == size:
        return x
    widths = (0, size - n) if dim == -1 else (0, 0, 0, size - n)
    return torch.nn.functional.pad(x, widths, value=value)


def layer_segments(cache, pad: bool = False) -> list:
    """The non-empty segments of a `PagedKVCache` in walk order: hi, lo,
    window."""
    segs = [_store_operands(s, pad) for s in (cache.hi, cache.lo) if s.table.shape[1]]
    if cache.win_table.shape[1]:
        segs.append(_window_operands(cache, pad))
    return segs


def _segment_stats_ref(q, ops: dict, scale: float, want_weights: bool):
    """One segment's (acc, m, l, p relative to m or None), plain version."""
    acc, m, l, p = R.paged_segment_ref(
        q, ops["k_pages"], ops["k_scale"], ops["k_zero"], ops["v_pages"], ops["v_cscale"],
        ops["v_tscale"], ops["v_tzero"], ops["pos"], ops["table"], k_bits=ops["k_bits"],
        v_bits=ops["v_bits"], scale=scale, k_dtype=ops["k_dtype"], v_dtype=ops["v_dtype"])
    return acc, m, l, p if want_weights else None


def attend_paged(q: torch.Tensor, cache, scale: Optional[float] = None, use_ref: bool = False,
                 want_weights: bool = True) -> kvc.DecodeAttnOut:
    """One-token decode attention over a `PagedKVCache`, no dense gather.

    q (b, h, d).  Returns DecodeAttnOut(out (b,h,dv) in q's dtype,
    slot_weights (b, S_hi+S_lo+W) f32 in hi/lo/window order, or None without
    `want_weights`).  One `kernel.qattn_paged_layer` call takes every
    segment; use_ref=True runs the plain page walk per segment
    (`ref.paged_segment_ref`, padded operands) and `ref.merge_segments_weights`."""
    scale = float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if use_ref:
        segs = layer_segments(cache, pad=True)
        out, weights = R.merge_segments_weights(
            [_segment_stats_ref(q, ops, scale, want_weights) for ops in segs])
        slot_w = None
        if weights is not None:
            slot_w = torch.cat([w[:, :, :ops["s_seg"]].mean(dim=1)
                                for w, ops in zip(weights, segs)], dim=-1)
        return kvc.DecodeAttnOut(out.to(q.dtype), slot_w)
    out, m, l, p, m_run = K.qattn_paged_layer(q, layer_segments(cache), scale=scale,
                                              want_weights=want_weights)
    slot_w = None
    if want_weights:
        slot_w = (p * (torch.exp(m_run - m[..., None]) / l.clamp_min(1e-30)[..., None])).mean(1)
    return kvc.DecodeAttnOut(out.to(q.dtype), slot_w)
