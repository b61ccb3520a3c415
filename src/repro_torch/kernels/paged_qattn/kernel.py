"""Launch wrappers of the paged decode attention kernel (`csrc/paged_qattn.cu`).

Replaces `src/repro/kernels/paged_qattn/kernel.py::qattn_paged_segment`.
Bound on the H100: bytes (every referenced page is read once per step), so
the kernel is set by latency.  One launch takes a whole decode layer: up to
three segments (4-bit hi, 2-bit lo, raw window) walked as one sequence of
32-slot blocks, split over CTAs on the whole layer (about eight per SM);
four lanes share a slot and read its code row in runs of 16 bytes or more,
and a second small kernel merges the CTAs' partial stats in
segment-then-split order (deterministic, no atomics) into the normalized
output.  Slots at or past a
segment's valid length, or with pos < 0, are masked in the kernel, so no
operand is padded.  `qattn_paged_segment`, the TPU kernel's counterpart,
is the one-segment call of the same kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_qattn import ref

LIB = build.CudaLibrary("paged_qattn")
KERNEL = build.CudaKernel(LIB, "paged_qattn_launch",
                          [build.P, build.P, build.I] + [build.P] * 9 + [build.I] * 4
                          + [build.F, build.I, build.I, build.I, build.P])
HEAD_DIMS = (16, 32, 64, 128)
GROUPS = (1, 2, 4, 8)  # query heads per kv head
CODE_BITS = (2, 4, 8)
SLOT_BLOCK = 32        # logical slots per block of the walk (one pass of a CTA)
TARGET_CTAS = 528      # four per SM of an H100: one wave at the split kernel's residency
MAX_SPLITS = 4096
_FLOATS = (torch.bfloat16, torch.float32)
_SEG_KEYS = ("k_pages", "k_scale", "k_zero", "v_pages", "v_cscale", "v_tscale", "v_tzero", "pos",
             "table")


class SegDesc(ctypes.Structure):
    """Mirror of the source's `SegDesc`."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("kpool", "vpool", "ks", "kz", "vcs", "vts", "vtz",
                                                "pos", "table")] + \
               [(n, ctypes.c_int) for n in ("npp", "page", "k_bits", "v_bits", "s_seg", "t_bf16")]


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _describe(q: torch.Tensor, seg: dict):
    """Check one segment's operands; (SegDesc, the tensors it points at)."""
    b, h, d = q.shape
    k_pages, v_pages, pos, table = seg["k_pages"], seg["v_pages"], seg["pos"], seg["table"]
    _, hk, page, _ = k_pages.shape
    npp, s_seg = table.shape[1], pos.shape[-1]
    k_bits, v_bits = seg["k_bits"], seg["v_bits"]
    raw = k_bits >= 16
    if raw != (v_bits >= 16):
        raise ValueError("paged_qattn: K and V must both be raw or both be quantized")
    if table.dtype != torch.int32 or pos.dtype != torch.int32 or pos.shape[0] != b \
            or table.shape[0] != b or s_seg == 0 or s_seg > npp * page:
        raise ValueError("paged_qattn: table (b, npp) and pos (b, s_seg) int32 with "
                         f"0 < s_seg <= npp * page; got pos {tuple(pos.shape)}, npp {npp}")
    params = tuple(seg[k] for k in ("k_scale", "k_zero", "v_cscale", "v_tscale", "v_tzero"))
    if raw:
        t_dtype = k_pages.dtype
        if t_dtype not in _FLOATS or v_pages.dtype != t_dtype:
            raise ValueError("paged_qattn: raw pages must share bf16 or f32")
        if k_pages.shape[-1] != d or v_pages.shape[-1] != d:
            raise ValueError(f"paged_qattn: raw pages of head dim {d} (K and V alike)")
        params = (None,) * 5
    else:
        t_dtype = params[0].dtype if params[0] is not None else None
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise ValueError("paged_qattn: quantized pages hold int8 codes")
        if t_dtype not in _FLOATS or any(p is None or p.dtype != t_dtype for p in params) \
                or seg["k_dtype"] != t_dtype or seg["v_dtype"] != t_dtype:
            raise ValueError("paged_qattn: the parameters and the rounding dtypes must share "
                             "bf16 or f32")
        if k_bits not in CODE_BITS or v_bits not in CODE_BITS or \
                k_pages.shape[-1] * (8 // k_bits) != d or v_pages.shape[-1] * (8 // v_bits) != d:
            raise ValueError(f"paged_qattn: code bits in {CODE_BITS} and packed widths of "
                             f"head dim {d}")
        if params[0].shape != (b, hk, 1, d) or params[2].shape != (b, hk, 1, d) \
                or params[3].shape != (b, hk, s_seg, 1) or params[4].shape != (b, hk, s_seg, 1):
            raise ValueError("paged_qattn: K / V channel parameters (b, hk, 1, d), V token "
                             "parameters (b, hk, s_seg, 1)")
    ts = [None if t is None else t.contiguous()
          for t in (k_pages, v_pages, *params, pos, table)]
    if any(t.data_ptr() % 16 for t in ts[:2]):
        raise ValueError("paged_qattn: page pools must be 16-byte aligned")
    desc = SegDesc(*(_ptr(t) for t in ts), npp, page, k_bits, v_bits, s_seg,
                   int(t_dtype == torch.bfloat16))
    return desc, ts


def _launch(q: torch.Tensor, segments: Sequence[dict], scale: float, want_weights: bool,
            normalized: bool):
    b, h, d = q.shape
    hk = segments[0]["k_pages"].shape[1]
    if q.dtype not in _FLOATS or d not in HEAD_DIMS or h % hk or h // hk not in GROUPS \
            or not 1 <= len(segments) <= 3:
        raise ValueError(f"paged_qattn: q bf16/f32 with head dim in {HEAD_DIMS}, h / hk in "
                         f"{GROUPS}, one to three segments; got {q.dtype} {tuple(q.shape)}, "
                         f"hk {hk}, {len(segments)} segments")
    if any(s["k_pages"].shape[1] != hk for s in segments):
        raise ValueError("paged_qattn: every segment has the same kv heads")
    descs, _operands = zip(*(_describe(q, s) for s in segments))  # alive through the launch
    arr = (SegDesc * len(descs))(*descs)
    n_blk = sum(-(-dd.s_seg // SLOT_BLOCK) for dd in descs)
    s_total = sum(dd.s_seg for dd in descs)
    # blocks per CTA: about TARGET_CTAS CTAs in all
    bpc = max(1, -(-n_blk * b * hk // TARGET_CTAS), -(-n_blk // MAX_SPLITS))
    nsplit = -(-n_blk // bpc)
    q = q.contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    n_part, n_bh = b * h * nsplit, b * h
    # one scratch buffer: acc_part | m_part | l_part | m | l [| p | m_run]
    n_w = 2 * n_bh * s_total if want_weights else 0
    buf = torch.empty(n_part * (d + 2) + 2 * n_bh + n_w, **f32)
    ml = buf[n_part * (d + 2):n_part * (d + 2) + 2 * n_bh].view(2, b, h)
    m, l = ml[0], ml[1]
    p = m_run = None
    if want_weights:
        w = buf[n_part * (d + 2) + 2 * n_bh:].view(2, b, h, s_total)
        p, m_run = w[0], w[1]
    res = torch.empty_like(q) if normalized else torch.empty((b, h, d), **f32)
    ptr0 = buf.data_ptr()
    KERNEL(_ptr(q), ctypes.addressof(arr), len(descs), ptr0, ptr0 + 4 * n_part * d,
           ptr0 + 4 * n_part * (d + 1), 0 if normalized else _ptr(res),
           _ptr(res) if normalized else 0, _ptr(m), _ptr(l), _ptr(p), _ptr(m_run),
           b, h, hk, d, scale, bpc, nsplit, int(q.dtype == torch.bfloat16), build.stream_of(q))
    return res, m, l, p, m_run


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
