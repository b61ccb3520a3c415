"""Launch wrapper of the paged decode attention kernel (`csrc/paged_qattn.cu`).

Replaces `src/repro/kernels/paged_qattn/kernel.py::qattn_paged_segment`.
Bound on the H100: bytes (every referenced page is read once per step).  A
segment has only b * hk (slot, kv head) pairs, so its logical slot axis is
split over CTAs too (about two CTAs per SM in all); each CTA loads its slots'
physical page ids from the table, unpacks 32-slot blocks into shared memory
once for the g query rows of the group, and a second small kernel merges the
splits' partial stats in order (deterministic, no atomics).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_qattn import ref

LIB = build.CudaLibrary("paged_qattn")
KERNEL = build.CudaKernel(LIB, "paged_qattn_launch",
                          [build.P] * 18 + [build.I] * 8 + [build.F] + [build.I] * 5 + [build.P])
HEAD_DIMS = (16, 32, 64, 128)
CODE_BITS = (2, 4, 8)
SLOT_BLOCK = 32      # logical slots per block of the kernel
TARGET_CTAS = 264    # two per SM of an H100
_FLOATS = (torch.bfloat16, torch.float32)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def qattn_paged_segment(q, k_pages, k_scale, k_zero, v_pages, v_cscale, v_tscale, v_tzero, pos,
                        table, *, k_bits: int, v_bits: int, scale: float,
                        k_dtype=torch.float32, v_dtype=torch.float32, want_weights: bool = True):
    """One-token attention over a paged store segment, pages read in place.

    q (b,h,d) | k_pages (P,hk,page,d/pf_k) | k params (b,hk,1,d)
    v_pages (P,hk,page,d/pf_v) | v_cscale (b,hk,1,d) | v_t* (b,hk,S_pad,1)
    pos (b,S_pad) int32 (<0 = empty) | table (b,npp) int32 physical page ids,
    S_pad == npp * page.  Raw segments (bits >= 16, K and V alike) hold bf16
    or f32 values and take no parameters; quantized ones hold int8 codes
    and round dequantized values to the parameters' dtype, which must equal
    k_dtype and v_dtype.

    Returns f32 (acc (b,h,d), m (b,h), l (b,h), p (b,h,S_pad),
    m_run (b,h,S_pad)): `p` is exp(s - m_run) per slot and 0 where invalid,
    so `p * exp(m_run - m)` is exp(s - m).  m_run is the running max of the
    CTA that owned the slot.  Without `want_weights`, p and m_run are None
    and never written.  CPU tensors take `ref.paged_segment_ref`.
    """
    if q.device.type == "cpu":
        acc, m, l, p = ref.paged_segment_ref(
            q, k_pages, k_scale, k_zero, v_pages, v_cscale, v_tscale, v_tzero, pos, table,
            k_bits=k_bits, v_bits=v_bits, scale=scale, k_dtype=k_dtype, v_dtype=v_dtype)
        if not want_weights:
            return acc, m, l, None, None
        return acc, m, l, p, m[..., None].expand_as(p)
    b, h, d = q.shape
    _, hk, page, _ = k_pages.shape
    npp = table.shape[1]
    s_pad = npp * page
    raw = k_bits >= 16
    if raw != (v_bits >= 16):
        raise ValueError("paged_qattn: K and V must both be raw or both be quantized")
    if q.dtype not in _FLOATS or d not in HEAD_DIMS or h % hk or s_pad == 0:
        raise ValueError(f"paged_qattn: q bf16/f32 with head dim in {HEAD_DIMS}, h % hk == 0, "
                         f"a non-empty segment; got {q.dtype} {tuple(q.shape)}, npp {npp}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32 or pos.shape != (b, s_pad):
        raise ValueError("paged_qattn: table and pos int32, pos (b, npp * page)")
    params = (k_scale, k_zero, v_cscale, v_tscale, v_tzero)
    if raw:
        t_dtype = k_pages.dtype
        if t_dtype not in _FLOATS or v_pages.dtype != t_dtype:
            raise ValueError("paged_qattn: raw pages must share bf16 or f32")
        if k_pages.shape[-1] != d or v_pages.shape[-1] != d:
            raise ValueError(f"paged_qattn: raw pages of head dim {d} (K and V alike)")
        params = (None,) * 5
    else:
        t_dtype = k_scale.dtype
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise ValueError("paged_qattn: quantized pages hold int8 codes")
        if t_dtype not in _FLOATS or any(p is None or p.dtype != t_dtype for p in params) \
                or k_dtype != t_dtype or v_dtype != t_dtype:
            raise ValueError("paged_qattn: the parameters and the rounding dtypes must share "
                             "bf16 or f32")
        if k_bits not in CODE_BITS or v_bits not in CODE_BITS or \
                k_pages.shape[-1] * (8 // k_bits) != d or v_pages.shape[-1] * (8 // v_bits) != d:
            raise ValueError(f"paged_qattn: code bits in {CODE_BITS} and packed widths of "
                             f"head dim {d}")
        if v_cscale.shape[-1] != d or v_tscale.shape[-2] != s_pad:
            raise ValueError("paged_qattn: V parameters of head dim d, token params padded to "
                             "npp * page")
    n_blocks = -(-s_pad // SLOT_BLOCK)
    per_split = max(1, -(-n_blocks * b * hk // TARGET_CTAS))
    n_split = -(-n_blocks // per_split)
    ts = [None if t is None else t.contiguous()
          for t in (q, k_pages, *params[:2], v_pages, *params[2:], pos, table)]
    f32 = dict(dtype=torch.float32, device=q.device)
    scratch = (torch.empty((b, h, n_split, d), **f32), torch.empty((b, h, n_split), **f32),
               torch.empty((b, h, n_split), **f32))
    acc, m, l = torch.empty((b, h, d), **f32), torch.empty((b, h), **f32), torch.empty((b, h), **f32)
    p = m_run = None
    if want_weights:
        p, m_run = torch.empty((b, h, s_pad), **f32), torch.empty((b, h, s_pad), **f32)
    KERNEL(*(_ptr(t) for t in (*ts, *scratch, acc, m, l, p, m_run)),
           b, h, hk, page, npp, d, 8 if raw else k_bits, 8 if raw else v_bits, scale,
           per_split, n_split, int(q.dtype == torch.bfloat16), int(t_dtype == torch.bfloat16),
           int(raw), build.stream_of(q))
    return acc, m, l, p, m_run
