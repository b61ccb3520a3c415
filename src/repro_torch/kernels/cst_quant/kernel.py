"""Launch wrappers of the cache-store quantization kernel (`csrc/cst_quant.cu`).

Replaces `src/repro/kernels/cst_quant/kernel.py::cst_quantize_pallas` and,
on the live path, the store quantizer around it (`repro.core.kvcache.
_quantize_kv` under the zipcache policy: K channelwise, V CSTQuant).  Bound
on the H100: bytes.  `quantize_store` is one launch per cache store: it
gathers the store's tokens from K and V (zero rows where the slot index is
-1), computes K's channel parameters and V's channel scale, and writes the
codes and the store-dtype parameters of both, each (batch row, kv head,
tensor) on `split` CTAs that stage their slots in shared memory once (a
thread-block cluster when split > 1).  `cst_quant_rows`, the TPU kernel's
counterpart (rows against a given channel scale, f32 parameters), is the V
instantiation of the same kernel.  A store under a precision map or a
downshift rung passes `eff`, effective bits per (batch row, kv head,
tensor): the kernel's instantiation with an eff table, which turns each
entry into its qmax.  CPU tensors take `ref`.
"""

from __future__ import annotations

import struct

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cst_quant import ref

LIB = build.CudaLibrary("cst_quant")
KERNEL = build.CudaKernel(LIB, "cst_store_launch", [build.P] + [build.I] * 5 + [build.P])
# the launches of KERNEL that took an eff table (a precision map or a rung)
EFF = build.Counter()
BITS = (2, 4, 8)
FLOATS = (torch.bfloat16, torch.float32)
THREADS, WARPS = 512, 16
SMEM_MAX = 232448      # dynamic shared memory a CTA may take on an H100
MAX_CLUSTER = 8        # CTAs per slice: a cluster of the portable size at most
TARGET_CTAS = 132      # one per SM: `_split` spreads a store over about this many CTAs
ROWS_PER_CTA = 64      # cst_quant_rows: rows per CTA


# The source's `StoreDesc`, packed: src[2], idx, c_in, codes[2], scale[2],
# zero[2], cscale, eff (pointers; tensor 0 is K, 1 is V); sb[2], sh[2],
# sl[2] (int64 strides); d[2], hk, S, has_k, rows_per_cta, chunk (int32);
# padding.
_DESC = struct.Struct("<12Q6q7i4x")


def head_dim_ok(d: int, bits: int, elem: int) -> bool:
    """Whether the kernel takes head dim d (elements of `elem` bytes): a row
    is a power of two of code words of 8 channels (4 at 8 bits), at most
    THREADS channels, in whole 16-byte pieces.  A thread owns one word up to
    a warp per row (256 channels, 128 at 8 bits) and 2 or 4 words of a
    wider row (MLA's 512-wide latent), so that a warp still owns a row."""
    vpw = 4 if bits == 8 else 8
    words = d // vpw
    return 0 < d <= THREADS and d % vpw == 0 and words & (words - 1) == 0 \
        and d * elem % 16 == 0


def _split(slices: int) -> int:
    """CTAs per (batch row, kv head, tensor): a power of two that keeps the
    grid within one CTA per SM, at most a cluster of MAX_CLUSTER."""
    split = 1
    while split < MAX_CLUSTER and 2 * split * slices <= TARGET_CTAS:
        split *= 2
    return split


def _source(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it: channel stride 1, 16-byte aligned rows."""
    e = x.element_size()
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(s * e % 16 for s in x.stride()[:-1]):
        x = x.contiguous()
    return x


def _chunk(rows_per_cta: int, dmax: int, elem: int) -> int:
    """Slots a CTA stages at once: all of its run where they fit."""
    room = SMEM_MAX - (2 * WARPS + 4) * dmax * 4 - 16
    return max(1, min(rows_per_cta, room // (dmax * elem + 4)))


def quantize_store(k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor, bits: int,
                   split: int = None, eff: torch.Tensor = None):
    """One cache store of the zipcache policy, K channelwise and V CST, in
    one launch.

    k (b, hk, l, dk), v (b, hk, l, dv) bf16 / f32 in one dtype, the store
    dtype; idx (b, S) int32: the source token of each slot, -1 = a zero row.
    Returns (k_codes (b, hk, S, dk/pf) int8, k_scale, k_zero (b, hk, 1, dk),
    v_codes (b, hk, S, dv/pf) int8, v_scale, v_zero (b, hk, S, 1), v_cscale
    (b, hk, 1, dv)), the parameters in the store dtype: those of
    `core.quant.quantize_channelwise` and `quantize_cst` on the gathered
    block, bit for bit.  `split` (a tuning argument: CTAs per batch row,
    kv head and tensor, 1 to MAX_CLUSTER) defaults to `_split`.  eff:
    optional (b, hk, 2) f32 effective bits of K and V per slice (1 to
    `bits`, whole numbers as a map and a rung make them); the quantizers
    then take qmax = 2**eff - 1, as `quantize_channelwise` / `quantize_cst`
    do with eff.  The split the launch used stays on `KERNEL.split`.
    """
    if k.device.type == "cpu":
        return ref.quantize_store_ref(k, v, idx, bits, eff)
    if k.device.type != "cuda":
        raise ValueError(f"cst_quant: unsupported device {k.device}")
    if k.dtype not in FLOATS or v.dtype != k.dtype or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3] or v.device != k.device:
        raise ValueError(f"cst_quant: K / V (b, hk, l, d) bf16 / f32 of one dtype; got K "
                         f"{k.dtype} {tuple(k.shape)}, V {v.dtype} {tuple(v.shape)}")
    b, hk, _, dk = k.shape
    dv = v.shape[-1]
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != b or idx.shape[1] == 0 \
            or idx.device != k.device:
        raise ValueError(f"cst_quant: idx ({b}, S > 0) int32 on {k.device}; got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    elem = k.element_size()
    if bits not in BITS or not head_dim_ok(dk, bits, elem) or not head_dim_ok(dv, bits, elem):
        raise ValueError(f"cst_quant: bits {bits} (one of {BITS}) with head dims {dk} / {dv}")
    if eff is not None:
        if eff.shape != (b, hk, 2) or eff.dtype != torch.float32 or eff.device != k.device:
            raise ValueError(f"cst_quant: eff ({b}, {hk}, 2) f32 on {k.device}; got "
                             f"{eff.dtype} {tuple(eff.shape)}")
        eff = eff.contiguous()
    split = split or _split(2 * b * hk)
    if not 1 <= split <= MAX_CLUSTER:
        raise ValueError(f"cst_quant: split {split} outside 1..{MAX_CLUSTER}")
    s = idx.shape[1]
    k, v, idx = _source(k), _source(v), idx.contiguous()
    dev = k.device
    kc = torch.empty((b, hk, s, dk * bits // 8), dtype=torch.int8, device=dev)
    vc = torch.empty((b, hk, s, dv * bits // 8), dtype=torch.int8, device=dev)
    ks, kz = torch.empty((2, b, hk, 1, dk), dtype=k.dtype, device=dev).unbind(0)
    vs, vz = torch.empty((2, b, hk, s, 1), dtype=k.dtype, device=dev).unbind(0)
    vcs = torch.empty((b, hk, 1, dv), dtype=k.dtype, device=dev)
    rpc = -(-s // split)
    (ksb, ksh, ksl, _), (vsb, vsh, vsl, _) = k.stride(), v.stride()
    desc = _DESC.pack(k.data_ptr(), v.data_ptr(), idx.data_ptr(), 0, kc.data_ptr(),
                      vc.data_ptr(), ks.data_ptr(), vs.data_ptr(), kz.data_ptr(), vz.data_ptr(),
                      vcs.data_ptr(), 0 if eff is None else eff.data_ptr(), ksb, vsb, ksh, vsh,
                      ksl, vsl, dk, dv, hk, s, 1, rpc,
                      _chunk(rpc, max(dk, dv), elem))
    KERNEL(desc, b, split, bits, int(k.dtype == torch.bfloat16), 0, build.stream_of(k))
    if eff is not None:
        EFF.launches += 1
    KERNEL.split = split
    return kc, ks, kz, vc, vs, vz, vcs


def cst_quant_rows(x: torch.Tensor, c: torch.Tensor, bits: int):
    """x (B, T, C) bf16/f32, c (B, C) f32 -> (codes (B, T, C/pf) int8,
    scale (B, T) f32, zero (B, T) f32).  CPU tensors take `ref`."""
    if x.device.type == "cpu":
        return ref.cst_quant_rows_ref(x, c, bits)
    if x.device.type != "cuda":
        raise ValueError(f"cst_quant: unsupported device {x.device}")
    if x.dtype not in FLOATS or x.dim() != 3:
        raise ValueError(f"cst_quant: x must be (B, T, C) bf16/f32, got {x.dtype} {tuple(x.shape)}")
    bsz, t, ch = x.shape
    if bits not in BITS or not head_dim_ok(ch, bits, x.element_size()):
        raise ValueError(f"cst_quant: bits {bits} with {ch} channels")
    if c.shape != (bsz, ch) or c.dtype != torch.float32 or c.device != x.device:
        raise ValueError(f"cst_quant: channel scale must be ({bsz}, {ch}) f32 on {x.device}")
    x, c = _source(x), c.contiguous()
    codes = torch.empty((bsz, t, ch * bits // 8), dtype=torch.int8, device=x.device)
    sz = torch.empty((2, bsz, t), dtype=torch.float32, device=x.device)
    if t:
        rpc = min(t, ROWS_PER_CTA)
        desc = _DESC.pack(0, x.data_ptr(), 0, c.data_ptr(), 0, codes.data_ptr(), 0,
                          sz[0].data_ptr(), 0, sz[1].data_ptr(), 0, 0, 0, x.stride(0), 0, 0, 0,
                          x.stride(1), 0, ch, 1, t, 0, rpc, _chunk(rpc, ch, x.element_size()))
        KERNEL(desc, bsz, -(-t // rpc), bits, int(x.dtype == torch.bfloat16), 1,
               build.stream_of(x))
    return codes, sz[0], sz[1]
