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


def kernel_supported(cache) -> bool:
    """Per-store check of a `MixedKVCache`: every non-empty store must be in
    the walk's schemes, so ZipCache's quantized stores and the raw stores of
    fp16 and h2o qualify, and KIVI's, GEAR's and MiKV's do not."""
    return all(walk.store_supported(s.k, s.v) for s in (cache.hi, cache.lo) if s.capacity)


def mixed_segments(cache) -> list:
    """The non-empty segments of a `MixedKVCache` in walk order (hi, lo,
    window), as `kernel.qattn_mixed_layer` takes them."""
    segs = []
    for store in (cache.hi, cache.lo):
        if store.capacity == 0:
            continue
        kq, vq = store.k, store.v
        seg = dict(k_codes=kq.codes, v_codes=vq.codes, pos=store.pos, k_bits=kq.bits,
                   v_bits=vq.bits)
        if kq.bits < 16:
            seg.update(k_scale=kq.scale, k_zero=kq.zero, v_cscale=vq.channel_scale,
                       v_tscale=vq.scale, v_tzero=vq.zero)
        segs.append(seg)
    if cache.window:
        segs.append(dict(k_codes=cache.k_win, v_codes=cache.v_win, pos=cache.win_pos,
                         k_bits=16, v_bits=16))
    return segs


def decode_attend_mixed(q: torch.Tensor, cache) -> torch.Tensor:
    """q (b, h, d) over a `MixedKVCache` -> out (b, h, dv) in q's dtype."""
    return K.qattn_mixed_layer(q, mixed_segments(cache))
