"""Decode attention over the mixed cache through the packed-store kernel.

`decode_attend_mixed` runs the hi and lo stores through `qattn_segment`,
the raw bf16 window through the plain segment function, and merges the
segments flash-decoding style.  It needs the ZipCache layout (channelwise
K, CST V) and yields no slot weights: probe steps take
`core.kvcache.attend_decode` instead.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_qattn import kernel as K
from repro_torch.kernels.decode_qattn import ref as R


def decode_attend_mixed(q: torch.Tensor, cache) -> torch.Tensor:
    """q (b, h, d) over a `MixedKVCache` -> out (b, h, dv) in q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    stats = []
    for store in (cache.hi, cache.lo):
        if store.capacity == 0:
            continue
        kq, vq = store.k, store.v
        if kq.bits >= 16:
            stats.append(R.segment_attend_ref(q, kq.dequantize().float(), vq.dequantize().float(),
                                              store.valid, scale))
        else:
            stats.append(K.qattn_segment(q, kq.codes, kq.scale, kq.zero, vq.codes,
                                         vq.channel_scale, vq.scale, vq.zero, store.pos,
                                         kq.bits, vq.bits))
    if cache.window:
        stats.append(R.segment_attend_ref(q, cache.k_win.float(), cache.v_win.float(),
                                          cache.win_pos >= 0, scale))
    return R.merge_segments_ref(stats).to(q.dtype)
