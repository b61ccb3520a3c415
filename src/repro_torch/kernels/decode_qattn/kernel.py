"""Launch wrapper of the packed-store decode attention kernel
(`csrc/decode_qattn.cu`).

Replaces `src/repro/kernels/decode_qattn/kernel.py::qattn_segment`, with
the store-dtype rounding of dequantized K/V that the reference's live path
(`QuantizedTensor.dequantize`) applies.  Bound on the H100: bytes (every
packed code is read once per step).  A store has only b * hk (batch, kv
head) pairs, so the slot axis is split over CTAs too (about two CTAs per
SM in all); each unpacks its 32-slot blocks into shared memory once for all
g query rows, and a second small kernel merges the splits' partial stats.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_qattn import ref

LIB = build.CudaLibrary("decode_qattn")
KERNEL = build.CudaKernel(LIB, "decode_qattn_launch",
                          [build.P] * 15 + [build.I] * 7 + [build.F] + [build.I] * 3 + [build.P])
HEAD_DIMS = (16, 32, 64, 128)
SLOT_BLOCK = 32      # slots per block of the kernel
TARGET_CTAS = 264    # two per SM of an H100


def qattn_segment(q, k_codes, k_scale, k_zero, v_codes, v_cscale, v_tscale, v_tzero, pos,
                  k_bits: int, v_bits: int):
    """One-token attention over a packed store segment.

    q (b,h,d) | k_codes (b,hk,S,d/pf) int8 | k params (b,hk,1,d)
    v_codes (b,hk,S,d/pf) int8 | v_cscale (b,hk,1,d) | v_t* (b,hk,S,1)
    pos (b,S) int32.  q and the parameters share the store dtype.
    Returns (acc (b,h,d) f32, m (b,h) f32, l (b,h) f32).
    CPU tensors take `ref.qattn_segment_ref`.
    """
    if q.device.type == "cpu":
        return ref.qattn_segment_ref(q, k_codes, k_scale, k_zero, v_codes, v_cscale, v_tscale,
                                     v_tzero, pos, k_bits, v_bits)
    b, h, d = q.shape
    hk, s_len = k_codes.shape[1], k_codes.shape[2]
    params = (k_scale, k_zero, v_cscale, v_tscale, v_tzero)
    if q.dtype not in (torch.bfloat16, torch.float32) or any(p.dtype != q.dtype for p in params):
        raise ValueError("decode_qattn: q and the store parameters must share bf16 or f32")
    if k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8 or pos.dtype != torch.int32:
        raise ValueError("decode_qattn: codes int8, pos int32")
    if d not in HEAD_DIMS or v_cscale.shape[-1] != d or h % hk or s_len == 0:
        raise ValueError(f"decode_qattn: head dim {d} (K and V alike) in {HEAD_DIMS}, "
                         f"h % hk == 0, a non-empty store")
    if k_codes.shape[-1] * (8 // k_bits) != d or v_codes.shape[-1] * (8 // v_bits) != d:
        raise ValueError("decode_qattn: shapes disagree with the bit widths")
    n_blocks = -(-s_len // SLOT_BLOCK)
    per_split = max(1, -(-n_blocks * b * hk // TARGET_CTAS))
    n_split = -(-n_blocks // per_split)
    ts = [t.contiguous() for t in (q, k_codes, k_scale, k_zero, v_codes, v_cscale, v_tscale,
                                   v_tzero, pos)]
    f32 = dict(dtype=torch.float32, device=q.device)
    scratch = (torch.empty((b, h, n_split, d), **f32), torch.empty((b, h, n_split), **f32),
               torch.empty((b, h, n_split), **f32))
    acc, m, l = torch.empty((b, h, d), **f32), torch.empty((b, h), **f32), torch.empty((b, h), **f32)
    KERNEL(*(build.ptr(t) for t in (*ts, *scratch, acc, m, l)),
           b, h, hk, s_len, d, k_bits, v_bits, 1.0 / (d ** 0.5), per_split, n_split,
           int(q.dtype == torch.bfloat16), build.stream_of(q))
    return acc, m, l
