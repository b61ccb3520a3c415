"""Launch wrappers of the mixed-cache decode attention kernel
(`csrc/decode_qattn.cu`).

Replaces `src/repro/kernels/decode_qattn/kernel.py::qattn_segment`, with
the store-dtype rounding of dequantized K/V that the reference's live path
(`QuantizedTensor.dequantize`) applies.  Bound on the H100: bytes (every
packed code is read once per step), so the kernel is set by latency.  One
launch takes a whole decode layer (`qattn_mixed_layer`): the 4-bit hi
store, the 2-bit lo store and the raw bf16 window, walked as one sequence
of 32-slot blocks split over CTAs on the whole layer, four lanes per slot
reading 16-byte runs of its code row, and a second small kernel that
merges the CTAs' partial stats in segment-then-split order (deterministic,
no atomics) into the normalized output.  The walk is `paged_qattn`'s
(`csrc/qattn_walk.cuh`, host side `kernels.qattn_walk`) with contiguous
addressing: each segment is one (b, hk, S, c) tensor and no table is read.
`qattn_segment`, the TPU kernel's counterpart, is the one-segment call of
the same kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels import qattn_walk as walk
from repro_torch.kernels.decode_qattn import ref

LIB = build.CudaLibrary("decode_qattn")
KERNEL = build.CudaKernel(LIB, "decode_qattn_launch", walk.ARGTYPES)
TARGET_CTAS = 528      # four per SM of an H100, as paged_qattn's walk
_PARAM_KEYS = ("k_scale", "k_zero", "v_cscale", "v_tscale", "v_tzero")
# layer launches that returned the merged statistics (a slot split's
# partials over a mesh) instead of the normalized output
STATS = build.Counter()


def _describe(q: torch.Tensor, seg: dict):
    """Check one segment's operands; (SegDesc, the tensors it points at)."""
    kc, vc, pos = seg["k_codes"], seg["v_codes"], seg["pos"]
    if kc.dim() != 4 or vc.dim() != 4 or kc.shape[0] != q.shape[0] \
            or tuple(vc.shape[:3]) != tuple(kc.shape[:3]) or pos.shape[-1] != kc.shape[2]:
        raise ValueError(f"decode_qattn: payloads (b, hk, S, c) and pos (b, S); got K "
                         f"{tuple(kc.shape)}, V {tuple(vc.shape)}, pos {tuple(pos.shape)}")
    return walk.describe("decode_qattn", q, kc, vc, tuple(seg.get(k) for k in _PARAM_KEYS), pos,
                         seg["k_bits"], seg["v_bits"], kc.shape[1])


def _launch(q: torch.Tensor, segments: Sequence[dict], normalized: bool, plan=None):
    if not segments:
        raise ValueError("decode_qattn: one to three segments")
    hk = segments[0]["k_codes"].shape[1]
    if any(s["k_codes"].shape[1] != hk for s in segments):
        raise ValueError("decode_qattn: every segment has the same kv heads")
    descs, _operands = zip(*(_describe(q, s) for s in segments))  # alive through the launch
    return walk.launch(KERNEL, "decode_qattn", q, descs, hk, 1.0 / (q.shape[-1] ** 0.5),
                       TARGET_CTAS, want_weights=False, normalized=normalized, plan_bh=plan)


def qattn_mixed_layer(q: torch.Tensor, segments: Sequence[dict], stats: bool = False,
                      plan=None):
    """One-token attention over a decode layer's mixed-cache segments, one launch.

    q (b,h,d) | segments: one to three dicts in walk order (hi, lo,
    window), each with k_codes / v_codes (b,hk,S,c): int8 codes, or raw
    bf16 / f32 values where k_bits / v_bits >= 16; k_scale / k_zero /
    v_cscale (b,hk,1,d) and v_tscale / v_tzero (b,hk,S,1) of a quantized
    segment, in its store dtype (absent or None for a raw one); pos (b,S)
    int32 (< 0 = empty).  Scale d^-1/2.

    Returns out (b,h,d) in q's dtype, normalized over every segment; with
    `stats`, the merged softmax statistics instead, (acc (b,h,d) f32
    unnormalized, m (b,h), l (b,h)), which partials over other slots merge
    with (a slot split over a mesh).  plan: the (rows x kv heads) the
    walk's split plan is made for (default b * hk): a share of a layer's
    heads launched with the whole layer's plan sums each head as the whole
    launch does.  CPU tensors take `ref.mixed_layer_ref`.
    """
    if q.device.type == "cpu":
        return ref.mixed_layer_ref(q, segments, stats=stats)
    if stats:
        acc, m, l, _, _ = _launch(q, segments, normalized=False, plan=plan)
        STATS.launches += 1
        return acc, m, l
    return _launch(q, segments, normalized=True, plan=plan)[0]


def qattn_segment(q, k_codes, k_scale, k_zero, v_codes, v_cscale, v_tscale, v_tzero, pos,
                  k_bits: int, v_bits: int):
    """One-token attention over a packed store segment.

    q (b,h,d) | k_codes (b,hk,S,d/pf) int8 | k params (b,hk,1,d)
    v_codes (b,hk,S,d/pf) int8 | v_cscale (b,hk,1,d) | v_t* (b,hk,S,1)
    pos (b,S) int32.  The parameters share the store dtype.
    Returns (acc (b,h,d) f32, m (b,h) f32, l (b,h) f32).
    CPU tensors take `ref.qattn_segment_ref`.
    """
    if q.device.type == "cpu":
        return ref.qattn_segment_ref(q, k_codes, k_scale, k_zero, v_codes, v_cscale, v_tscale,
                                     v_tzero, pos, k_bits, v_bits)
    seg = dict(k_codes=k_codes, k_scale=k_scale, k_zero=k_zero, v_codes=v_codes,
               v_cscale=v_cscale, v_tscale=v_tscale, v_tzero=v_tzero, pos=pos, k_bits=k_bits,
               v_bits=v_bits)
    acc, m, l, _, _ = _launch(q, [seg], normalized=False)
    return acc, m, l
