"""Decode attention over the mixed cache through the layer kernel.

`decode_attend_mixed` hands the hi store, the lo store and the raw bf16
window to one `qattn_mixed_layer` call, which walks the three segments and
merges them flash-decoding style.  It needs every non-empty store in the
walk's schemes (`kernel_supported`: channelwise K, CST V, or raw >= 16-bit
values, as the paged layout's gate checks them) and yields no slot
weights: probe steps take `core.kvcache.attend_decode` instead.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import qattn_walk as walk
from repro_torch.kernels.decode_qattn import kernel as K
from repro_torch.kernels.decode_qattn import ref


def kernel_supported(cache) -> bool:
    """Per-store check of a `MixedKVCache`: every non-empty store must be in
    the walk's schemes, so ZipCache's quantized stores and the raw stores of
    fp16 and h2o qualify, and KIVI's, GEAR's and MiKV's do not."""
    return all(walk.store_supported(s.k, s.v) for s in (cache.hi, cache.lo) if s.capacity)


def mixed_segments(cache, taken=None) -> list:
    """The non-empty segments of a `MixedKVCache` in walk order (hi, lo,
    window), as `kernel.qattn_mixed_layer` takes them; taken: (hi, lo,
    window) flags, the segments to keep (default: all)."""
    taken = taken or (True, True, True)
    segs = []
    for store, keep in zip((cache.hi, cache.lo), taken):
        if store.capacity == 0 or not keep:
            continue
        kq, vq = store.k, store.v
        seg = dict(k_codes=kq.codes, v_codes=vq.codes, pos=store.pos, k_bits=kq.bits,
                   v_bits=vq.bits)
        if kq.bits < 16:
            seg.update(k_scale=kq.scale, k_zero=kq.zero, v_cscale=vq.channel_scale,
                       v_tscale=vq.scale, v_tzero=vq.zero)
        segs.append(seg)
    if cache.window and taken[2]:
        segs.append(dict(k_codes=cache.k_win, v_codes=cache.v_win, pos=cache.win_pos,
                         k_bits=16, v_bits=16))
    return segs


def segment_share(seg: dict, dim: int, i: int, n: int) -> dict:
    """Block i of n of a segment's operands along `dim` (1: kv heads, 2:
    slots), each a contiguous copy: the channelwise K and CST channel
    scales hold no slot dim, the positions (b, S) no head dim.  What a rank
    of a head or slot split holds of `mixed_segments`' segment."""
    out = dict(seg)
    for key, t in seg.items():
        if not hasattr(t, "shape"):
            continue
        if key == "pos":
            d_ = None if dim == 1 else 1
        else:
            d_ = None if dim == 2 and t.shape[2] == 1 else dim
        if d_ is not None:
            out[key] = t.chunk(n, d_)[i].contiguous()
    return out


def decode_attend_mixed(q: torch.Tensor, cache, stats: bool = False, plan=None, taken=None):
    """q (b, h, d) over a `MixedKVCache` -> out (b, h, dv) in q's dtype, or
    with `stats` the merged (acc, m, l) (`kernel.qattn_mixed_layer`).
    taken: (hi, lo, window) flags, the segments this call reads (a slot
    split reads a segment held whole on one rank only); none taken gives
    an empty partial, and no launch.  plan: the walk's split plan's (rows x
    kv heads)."""
    segs = mixed_segments(cache, taken)
    if not segs:
        return ref.empty_stats(q, cache.v_win.shape[-1])
    return K.qattn_mixed_layer(q, segs, stats=stats, plan=plan)
