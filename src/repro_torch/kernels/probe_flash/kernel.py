"""Launch wrappers of the probe-flash kernels (`csrc/probe_flash.cu`).

`flash_fwd` replaces `src/repro/kernels/probe_flash/kernel.py::flash_fwd`
and `probe_colsum` replaces `::probe_colsum`.  Bound on the H100:
operations (attention at prefill widths).  `flash_fwd` in bf16, the main
path's type, runs FlashAttention-2 on the tensor cores (`mma.sync` with
`cp.async`-staged K/V tiles); in f32 it computes on the CUDA cores.
`probe_colsum` in bf16 runs the probe-row scores on the tensor cores
(`mma.sync`, a `cp.async` Q ring), one CTA per (64 key columns, one
to eight query heads of a kv group, batch row), skipping probe tiles that lie
wholly above the causal diagonal; in f32 it computes on the CUDA cores, one CTA per (32 key
columns, batch, kv head).  Each CTA owns its key columns for its head(s),
and a second small kernel adds the heads' partials in order, so the sums
are deterministic without atomics.  See the source for the design.

Head dims: `flash_fwd` takes the (q/k, v) pairs of `FLASH_PAIRS` ((d, d)
for the GQA widths; (192, 128) for DeepSeek-V2's MLA prefill and (32, 16)
its smoke width), `probe_colsum` the q/k dims of `HEAD_DIMS`.  A shape they
do not take raises."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.probe_flash import ref

LIB = build.CudaLibrary("probe_flash")
FLASH = build.CudaKernel(LIB, "flash_fwd_launch",
                         [build.P] * 5 + [build.I] * 8 + [build.F, build.I, build.P])
COLSUM = build.CudaKernel(LIB, "probe_colsum_launch",
                          [build.P] * 6 + [build.I] * 9 + [build.F, build.I, build.P])
HEAD_DIMS = (16, 32, 64, 128, 192)
FLASH_PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128), (32, 16))
# bf16 probe_colsum: as many query heads of one kv group per CTA as still
# give MIN_CTAS CTAs (about four per SM, the kernel's residency at 53 KB of
# shared memory each at d 128), else 1.  At d 192 a CTA takes 78 KB (two an
# SM); MLA's groups are one head (h == hk), so a CTA takes one head there.
MIN_CTAS = 512
COLSUM_COLS = 64  # key columns per CTA


def _check(name: str, dtype: torch.dtype, dims, allowed, *ts: torch.Tensor) -> None:
    if dtype not in (torch.bfloat16, torch.float32) or dims not in allowed:
        raise ValueError(f"{name}: dtype {dtype} / head dims {dims} not supported "
                         f"(bf16 or f32, head dims in {allowed})")
    for t in ts:
        if t.device != ts[0].device:
            raise ValueError(f"{name}: tensors on different devices")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True):
    """q (b,h,lq,d), k (b,hk,lkv,d), v (b,hk,lkv,dv) -> (out (b,h,lq,dv) in
    q's dtype, lse (b,h,lq) f32).  CPU tensors take `ref.flash_fwd_ref`."""
    if q.device.type == "cpu":
        return ref.flash_fwd_ref(q, k, v, causal=causal)
    b, h, lq, d = q.shape
    hk, lkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    _check("flash_fwd", q.dtype, (d, dv), FLASH_PAIRS, q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype or k.shape[-1] != d \
            or v.shape[:3] != k.shape[:3] or h % hk:
        raise ValueError("flash_fwd: q/k/v must share dtype, q/k their head dim, k/v their "
                         "heads and length, h % hk == 0")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, h, lq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    FLASH(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), build.ptr(lse),
          b, h, hk, lq, lkv, d, dv, int(causal), 1.0 / (d ** 0.5),
          int(q.dtype == torch.bfloat16), build.stream_of(q))
    return out, lse


def _heads_per_cta(b: int, h: int, g: int, lkv: int) -> int:
    col_blocks = -(-lkv // COLSUM_COLS)
    fits = [n for n in range(1, g + 1) if g % n == 0 and col_blocks * (h // n) * b >= MIN_CTAS]
    return max(fits, default=1)


def probe_colsum(qp: torch.Tensor, lse_p: torch.Tensor, pos: torch.Tensor, k: torch.Tensor,
                 causal: bool = True, lq: int = None) -> torch.Tensor:
    """qp (b,h,np,d), lse_p (b,h,np) f32, pos (b,np) int32 (< 0 = padding),
    k (b,hk,lkv,d) -> (b,lkv) f32.  CPU tensors take `ref.probe_colsum_ref`.
    The query heads per CTA the launch used stay on `COLSUM.heads_per_cta`."""
    if qp.device.type == "cpu":
        return ref.probe_colsum_ref(qp, lse_p, pos, k, causal=causal, lq=lq)
    b, h, n_p, d = qp.shape
    hk, lkv = k.shape[1], k.shape[2]
    lq = lkv if lq is None else lq
    _check("probe_colsum", qp.dtype, d, HEAD_DIMS, qp, lse_p, pos, k)
    if k.dtype != qp.dtype or lse_p.dtype != torch.float32 or pos.dtype != torch.int32 or h % hk:
        raise ValueError("probe_colsum: qp/k share a dtype, lse_p f32, pos int32, h % hk == 0")
    qp, lse_p, pos, k = qp.contiguous(), lse_p.contiguous(), pos.contiguous(), k.contiguous()
    bf16 = qp.dtype == torch.bfloat16
    if bf16 and (qp.data_ptr() % 16 or k.data_ptr() % 16):
        raise ValueError("probe_colsum: bf16 qp and k must be 16-byte aligned")
    # one partial column sum per hpc query heads (bf16, tensor cores) or per kv head (f32)
    hpc = _heads_per_cta(b, h, h // hk, lkv)
    partial = torch.empty((b, h // hpc if bf16 else hk, lkv), dtype=torch.float32,
                          device=qp.device)
    colsum = torch.empty((b, lkv), dtype=torch.float32, device=qp.device)
    COLSUM(build.ptr(qp), build.ptr(lse_p), build.ptr(pos), build.ptr(k), build.ptr(partial),
           build.ptr(colsum),
           b, h, hk, hpc, n_p, lq, lkv, d, int(causal), 1.0 / (d ** 0.5), int(bf16),
           build.stream_of(qp))
    COLSUM.heads_per_cta = hpc
    return colsum
