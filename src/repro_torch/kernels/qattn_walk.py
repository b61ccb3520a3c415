"""Host side of the decode-attention walk that `paged_qattn` and
`decode_qattn` share (`csrc/qattn_walk.cuh`): the segment descriptor and
the checks of its operands, the split sizing and the launch with its
scratch.

A layer's segments (one to three, in walk order) are walked as one sequence
of 32-slot blocks, split over CTAs on the whole layer; the merge kernel
writes the normalized output in q's dtype or, for a one-segment call, the
unnormalized f32 `acc` with its (m, l).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.core import quant
from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
GROUPS = (1, 2, 3, 4, 7, 8)  # query heads per kv head (g = 3: smollm; 7: qwen2, yi-34b)
CODE_BITS = (2, 4, 8)
SLOT_BLOCK = 32        # slots per block of the walk (one pass of a CTA)
MAX_SPLITS = 4096
FLOATS = (torch.bfloat16, torch.float32)
ARGTYPES = ([build.P, build.P, build.I] + [build.P] * 9 + [build.I] * 4
            + [build.F, build.I, build.I, build.I, build.P])


class SegDesc(ctypes.Structure):
    """Mirror of the source's `SegDesc`."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("kpool", "vpool", "ks", "kz", "vcs", "vts", "vtz",
                                                "pos", "table")] + \
               [(n, ctypes.c_int) for n in ("npp", "page", "k_bits", "v_bits", "s_seg", "t_bf16")]


def store_supported(k: "quant.QuantizedTensor", v: "quant.QuantizedTensor") -> bool:
    """Whether the walk reads a store as it is: K channelwise and V CST
    (ZipCache's schemes), either raw (>= 16 bits).  Groupwise and tokenwise
    stores (KIVI, GEAR, MiKV's V) take the gather route."""
    return quant.scheme_of(k) in ("raw", "channelwise") and quant.scheme_of(v) in ("raw", "cst")


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def describe(name: str, q: torch.Tensor, k_data: torch.Tensor, v_data: torch.Tensor,
             params: Sequence, pos: torch.Tensor, k_bits: int, v_bits: int, hk: int,
             table: torch.Tensor = None, npp: int = 0, page: int = 0, rounding: Sequence = ()):
    """Check one segment's operands but its payload layout, which the caller
    checks; (SegDesc, the tensors it points at).

    k_data / v_data hold int8 codes, or raw bf16 / f32 values where k_bits /
    v_bits >= 16 (K and V alike, and then `params` are ignored); params are
    (k_scale, k_zero, v_cscale) of shape (b, hk, 1, d) and (v_tscale,
    v_tzero) of shape (b, hk, S, 1) in one store dtype, which every dtype in
    `rounding` must equal; pos (b, S) int32 with S > 0.  `table` (with npp
    and page) is the paged addressing; None is contiguous.
    """
    b, h, d = q.shape
    s_seg = pos.shape[-1]
    raw = k_bits >= 16
    if raw != (v_bits >= 16):
        raise ValueError(f"{name}: K and V must both be raw or both be quantized")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b, s_seg) or s_seg == 0:
        raise ValueError(f"{name}: pos (b, S) int32 with S > 0; got {tuple(pos.shape)} "
                         f"{pos.dtype}")
    if raw:
        t_dtype = k_data.dtype
        if t_dtype not in FLOATS or v_data.dtype != t_dtype:
            raise ValueError(f"{name}: raw K / V must share bf16 or f32")
        if k_data.shape[-1] != d or v_data.shape[-1] != d:
            raise ValueError(f"{name}: raw K / V of head dim {d} (K and V alike)")
        params = (None,) * 5
    else:
        t_dtype = params[0].dtype if params[0] is not None else None
        if k_data.dtype != torch.int8 or v_data.dtype != torch.int8:
            raise ValueError(f"{name}: quantized K / V hold int8 codes")
        if t_dtype not in FLOATS or any(p is None or p.dtype != t_dtype for p in params) \
                or any(r != t_dtype for r in rounding):
            raise ValueError(f"{name}: the parameters and the rounding dtypes must share "
                             "bf16 or f32")
        if k_bits not in CODE_BITS or v_bits not in CODE_BITS or \
                k_data.shape[-1] * (8 // k_bits) != d or v_data.shape[-1] * (8 // v_bits) != d:
            raise ValueError(f"{name}: code bits in {CODE_BITS} and packed widths of head "
                             f"dim {d}")
        if any(tuple(p.shape) != (b, hk, 1, d) for p in params[:3]) \
                or any(tuple(p.shape) != (b, hk, s_seg, 1) for p in params[3:]):
            raise ValueError(f"{name}: K / V channel parameters (b, hk, 1, d), V token "
                             "parameters (b, hk, S, 1)")
    ts = [None if t is None else t.contiguous() for t in (k_data, v_data, *params, pos, table)]
    if any(t.data_ptr() % 16 for t in ts[:2]):
        raise ValueError(f"{name}: K / V payloads must be 16-byte aligned")
    desc = SegDesc(*(ptr(t) for t in ts), npp, page, k_bits, v_bits, s_seg,
                   int(t_dtype == torch.bfloat16))
    return desc, ts


def split_plan(descs: Sequence[SegDesc], b: int, hk: int, target_ctas: int,
               plan_bh: Optional[int] = None):
    """(blocks per CTA, splits per (row, kv head)) for a walk over `descs`:
    about `target_ctas` CTAs in all, at most MAX_SPLITS splits.  plan_bh:
    the (rows x kv heads) the plan is made for, where it is not b * hk (a
    rank's share of a layer split over a mesh takes the whole layer's plan,
    so each of its heads sums as the whole launch's does)."""
    n_blk = sum(-(-dd.s_seg // SLOT_BLOCK) for dd in descs)
    bh = b * hk if plan_bh is None else plan_bh
    bpc = max(1, -(-n_blk * bh // target_ctas), -(-n_blk // MAX_SPLITS))
    return bpc, -(-n_blk // bpc)


def launch(kernel: build.CudaKernel, name: str, q: torch.Tensor, descs: Sequence[SegDesc],
           hk: int, scale: float, target_ctas: int, want_weights: bool, normalized: bool,
           plan_bh: Optional[int] = None):
    """One launch of `kernel` over the described segments (whose tensors the
    caller keeps alive through the call).  Returns (out in q's dtype if
    `normalized` else acc f32, m, l, p or None, m_run or None).  The split
    count the launch used stays on `kernel.splits`."""
    b, h, d = q.shape
    if q.dtype not in FLOATS or d not in HEAD_DIMS or h % hk or h // hk not in GROUPS \
            or not 1 <= len(descs) <= 3:
        raise ValueError(f"{name}: q bf16/f32 with head dim in {HEAD_DIMS}, h / hk in "
                         f"{GROUPS}, one to three segments; got {q.dtype} {tuple(q.shape)}, "
                         f"hk {hk}, {len(descs)} segments")
    arr = (SegDesc * len(descs))(*descs)
    s_total = sum(dd.s_seg for dd in descs)
    bpc, nsplit = split_plan(descs, b, hk, target_ctas, plan_bh)
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
    kernel(ptr(q), ctypes.addressof(arr), len(descs), ptr0, ptr0 + 4 * n_part * d,
           ptr0 + 4 * n_part * (d + 1), 0 if normalized else ptr(res),
           ptr(res) if normalized else 0, ptr(m), ptr(l), ptr(p), ptr(m_run),
           b, h, hk, d, scale, bpc, nsplit, int(q.dtype == torch.bfloat16), build.stream_of(q))
    kernel.splits = nsplit
    return res, m, l, p, m_run
