"""Launch wrappers of the paged decode attention kernel (`csrc/paged_qattn.cu`).

Replaces `src/repro/kernels/paged_qattn/kernel.py::qattn_paged_segment`.
Bound on the H100: bytes (every referenced page is read once per step), so
the kernel is set by latency.  One launch takes a whole decode layer: up to
three segments (4-bit hi, 2-bit lo, raw window) walked as one sequence of
32-slot blocks, split over CTAs on the whole layer (about four per SM);
four lanes share a slot and read its code row in runs of 16 bytes or more,
and a second small kernel merges the CTAs' partial stats in
segment-then-split order (deterministic, no atomics) into the normalized
output.  Slots at or past a
segment's valid length, or with pos < 0, are masked in the kernel, so no
operand is padded.  `qattn_paged_segment`, the TPU kernel's counterpart,
is the one-segment call of the same kernel.  The walk and its host side
(`qattn_walk`) are shared with `decode_qattn`'s contiguous stores.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels import qattn_walk as walk
from repro_torch.kernels.paged_qattn import ref

LIB = build.CudaLibrary("paged_qattn")
KERNEL = build.CudaKernel(LIB, "paged_qattn_launch", walk.ARGTYPES)
TARGET_CTAS = 528      # four per SM of an H100: one wave at the split kernel's residency
_SEG_KEYS = ("k_pages", "k_scale", "k_zero", "v_pages", "v_cscale", "v_tscale", "v_tzero", "pos",
             "table")


def _describe(q: torch.Tensor, seg: dict):
    """Check one segment's operands; (SegDesc, the tensors it points at)."""
    k_pages, v_pages, pos, table = seg["k_pages"], seg["v_pages"], seg["pos"], seg["table"]
    _, hk, page, _ = k_pages.shape
    npp = table.shape[1]
    if table.dtype != torch.int32 or table.shape[0] != q.shape[0] \
            or pos.shape[-1] > npp * page:
        raise ValueError("paged_qattn: table (b, npp) int32 and pos (b, s_seg) with "
                         f"s_seg <= npp * page; got pos {tuple(pos.shape)}, npp {npp}")
    return walk.describe("paged_qattn", q, k_pages, v_pages,
                         tuple(seg[k] for k in ("k_scale", "k_zero", "v_cscale", "v_tscale",
                                                "v_tzero")),
                         pos, seg["k_bits"], seg["v_bits"], hk, table=table, npp=npp, page=page,
                         rounding=(seg.get("k_dtype"), seg.get("v_dtype")))


def _launch(q: torch.Tensor, segments: Sequence[dict], scale: float, want_weights: bool,
            normalized: bool):
    hk = segments[0]["k_pages"].shape[1]
    if any(s["k_pages"].shape[1] != hk for s in segments):
        raise ValueError("paged_qattn: every segment has the same kv heads")
    descs, _operands = zip(*(_describe(q, s) for s in segments))  # alive through the launch
    return walk.launch(KERNEL, "paged_qattn", q, descs, hk, scale, TARGET_CTAS, want_weights,
                       normalized)


def qattn_paged_layer(q: torch.Tensor, segments: Sequence[dict], *, scale: float,
                      want_weights: bool = True):
    """One-token attention over a decode layer's paged segments, one launch.

    q (b,h,d) | segments: one to three dicts in walk order (hi, lo,
    window), each with k_pages / v_pages (P,hk,page,c), k_scale / k_zero /
    v_cscale (b,hk,1,d), v_tscale / v_tzero (b,hk,s_seg,1), pos (b,s_seg)
    int32 (< 0 = empty), table (b,npp) int32, k_bits / v_bits (>= 16: raw
    bf16 or f32 pages, parameters None) and k_dtype / v_dtype (the
    parameters' dtype of a quantized segment).  s_seg <= npp * page: slots
    past s_seg are never read.

    Returns (out (b,h,d) normalized in q's dtype, m (b,h), l (b,h), p
    (b,h,S), m_run (b,h,S)) over the concatenated slots S = sum s_seg, all
    f32 but out: p * exp(m_run - m) / l is the softmax row.  Without
    `want_weights`, p and m_run are None and never written.  CPU tensors
    take `ref.paged_layer_ref`.
    """
    if q.device.type == "cpu":
        out, m, l, p = ref.paged_layer_ref(q, segments, scale=scale)
        if not want_weights:
            return out, m, l, None, None
        return out, m, l, p, m[..., None].expand_as(p)
    return _launch(q, segments, scale, want_weights, normalized=True)


def qattn_paged_segment(q, k_pages, k_scale, k_zero, v_pages, v_cscale, v_tscale, v_tzero, pos,
                        table, *, k_bits: int, v_bits: int, scale: float,
                        k_dtype=torch.float32, v_dtype=torch.float32, want_weights: bool = True):
    """One-token attention over a paged store segment, pages read in place.

    q (b,h,d) | k_pages (P,hk,page,d/pf_k) | k params (b,hk,1,d)
    v_pages (P,hk,page,d/pf_v) | v_cscale (b,hk,1,d) | v_t* (b,hk,S,1)
    pos (b,S) int32 (<0 = empty) | table (b,npp) int32 physical page ids,
    S <= npp * page.  Raw segments (bits >= 16, K and V alike) hold bf16
    or f32 values and take no parameters; quantized ones hold int8 codes
    and round dequantized values to the parameters' dtype, which must equal
    k_dtype and v_dtype.

    Returns f32 (acc (b,h,d), m (b,h), l (b,h), p (b,h,S), m_run (b,h,S)):
    `p` is exp(s - m_run) per slot and 0 where invalid, so
    `p * exp(m_run - m)` is exp(s - m).  m_run is the running max of the
    warp that owned the slot.  Without `want_weights`, p and m_run are None
    and never written.  CPU tensors take `ref.paged_segment_ref`.
    """
    if q.device.type == "cpu":
        acc, m, l, p = ref.paged_segment_ref(
            q, k_pages, k_scale, k_zero, v_pages, v_cscale, v_tscale, v_tzero, pos, table,
            k_bits=k_bits, v_bits=v_bits, scale=scale, k_dtype=k_dtype, v_dtype=v_dtype)
        if not want_weights:
            return acc, m, l, None, None
        return acc, m, l, p, m[..., None].expand_as(p)
    seg = dict(zip(_SEG_KEYS, (k_pages, k_scale, k_zero, v_pages, v_cscale, v_tscale, v_tzero,
                               pos, table)),
               k_bits=k_bits, v_bits=v_bits, k_dtype=k_dtype, v_dtype=v_dtype)
    return _launch(q, [seg], scale, want_weights, normalized=False)
