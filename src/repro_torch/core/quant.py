"""Quantization primitives for KV cache compression (port of `repro.core.quant`).

Tokenwise, channelwise, groupwise and channel-separable tokenwise (CSTQuant,
paper Alg. 1) uniform quantization with one API: quantize -> QuantizedTensor
-> dequantize.  All quantizers work on the LAST two axes as (tokens,
channels).  Every step repeats the reference's float32 arithmetic in the
same order (divide, round half to even, clip), so the packed codes are
bit-identical to the JAX package's for the same inputs.

Every quantizer takes an optional `eff`: effective-bit ceilings inside the
static container (`core.precision`), an f32 tensor that broadcasts against
the per-slice statistics.  qmax is then ``2**eff - 1`` (exact in f32 for an
integer eff) and scale, zero and the clip all use it; `eff=None` is the
static-qmax path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import packing

_EPS = 1e-8


@dataclasses.dataclass
class QuantizedTensor:
    """Bit-packed uniform-quantized tensor plus its quantization parameters.

    codes: int8 packed codes (..., T, C // pack_factor); bits == 16 holds the
        raw values instead.
    scale/zero: broadcastable to (..., T, C) (grouped: (..., T, C/g)).
    channel_scale: CSTQuant's per-channel normalizer c, (..., 1, C).
    shape: logical unpacked shape (..., T, C).
    """

    codes: torch.Tensor
    scale: Optional[torch.Tensor]
    zero: Optional[torch.Tensor]
    channel_scale: Optional[torch.Tensor]
    bits: int
    shape: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.codes.dtype if self.scale is None else self.scale.dtype

    def dequantize(self) -> torch.Tensor:
        """Dequantized values, ending with the cast to the store dtype."""
        if self.bits == 16:
            return self.codes.reshape(self.shape)
        x = packing.unpack(self.codes, self.bits, out_dtype=torch.float32)
        c = self.shape[-1]
        if self.scale.shape[-1] not in (1, c):
            g = c // self.scale.shape[-1]
            xg = x.reshape(*x.shape[:-1], c // g, g)
            xg = (xg - self.zero.float()[..., None]) * self.scale.float()[..., None]
            x = xg.reshape(*x.shape[:-1], c)
        else:
            x = (x - self.zero.float()) * self.scale.float()
        if self.channel_scale is not None:
            x = x * self.channel_scale.float()
        return x.reshape(self.shape).to(self.dtype)

    def nbytes_packed(self) -> int:
        """Bytes of the packed representation incl. quantization parameters
        (a paged store's metadata carries codes=None: its codes live in pages)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.codes, self.scale, self.zero, self.channel_scale)
                   if t is not None)


def scheme_of(q: QuantizedTensor) -> str:
    """The scheme a quantized tensor's parameter shapes imply: "raw" (16
    bits), "cst" (a channel normalizer), "channelwise" (params (..., 1, C)),
    "tokenwise" (..., T, 1) or "groupwise" (..., T, C / g).  Works on a
    paged store's metadata too (codes None)."""
    if q.bits >= 16:
        return "raw"
    if q.channel_scale is not None:
        return "cst"
    if q.scale.shape[-2:] == (1, q.shape[-1]):
        return "channelwise"
    return "tokenwise" if q.scale.shape[-1] == 1 else "groupwise"


def true_div(x: torch.Tensor, n: float) -> torch.Tensor:
    """x / n with one IEEE rounding.  On CUDA, PyTorch divides by a Python
    number as a multiply by its reciprocal, which is off by an ulp at
    times; a tensor divisor takes the true division, as the reference and
    the kernels compute it."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def _qmax(bits: int, eff=None):
    """The static integer qmax (eff None) or the effective one, ``2**eff -
    1`` in f32 (a tensor)."""
    return 2**bits - 1 if eff is None else torch.exp2(eff.float()) - 1.0


def _minmax_params(x: torch.Tensor, bits: int, dim: int, eff=None):
    """Uniform asymmetric min/max quantization parameters (paper Eq. 5)."""
    qmax = _qmax(bits, eff)
    xmin = x.amin(dim=dim, keepdim=True)
    xmax = x.amax(dim=dim, keepdim=True)
    # a tensor divisor is a true division already; a Python one needs true_div
    rng = xmax - xmin
    scale = (true_div(rng, qmax) if eff is None else rng / qmax).clamp_min(_EPS)
    zero = torch.round(-xmin / scale)
    return scale, zero


def _clip(q: torch.Tensor, bits: int, eff=None) -> torch.Tensor:
    if eff is None:
        return torch.clamp(q, 0, 2**bits - 1)
    return torch.minimum(q.clamp_min(0), _qmax(bits, eff))


def _encode(x: torch.Tensor, scale, zero, bits: int, eff=None) -> torch.Tensor:
    q = _clip(torch.round(x / scale + zero), bits, eff)
    return packing.pack(q.to(torch.uint8), bits)


def quantize_tokenwise(x: torch.Tensor, bits: int, eff=None) -> QuantizedTensor:
    """Per-token (channel-reduced) uniform quantization. x: (..., T, C)."""
    xf = x.float()
    scale, zero = _minmax_params(xf, bits, dim=-1, eff=eff)
    codes = _encode(xf, scale, zero, bits, eff=eff)
    return QuantizedTensor(codes, scale.to(x.dtype), zero.to(x.dtype), None, bits, tuple(x.shape))


def quantize_channelwise(x: torch.Tensor, bits: int, eff=None) -> QuantizedTensor:
    """Per-channel uniform quantization (token-reduced): the KEY scheme (§4.1)."""
    xf = x.float()
    scale, zero = _minmax_params(xf, bits, dim=-2, eff=eff)
    codes = _encode(xf, scale, zero, bits, eff=eff)
    return QuantizedTensor(codes, scale.to(x.dtype), zero.to(x.dtype), None, bits, tuple(x.shape))


def quantize_groupwise(x: torch.Tensor, bits: int, group_size: int = 32, eff=None) -> QuantizedTensor:
    """KIVI-style groupwise quantization along channels; params (..., T, C/g)."""
    *lead, t, c = x.shape
    if c % group_size:
        raise ValueError(f"channels {c} not divisible by group size {group_size}")
    if eff is not None:
        eff = torch.as_tensor(eff)[..., None]   # grouped statistics carry an extra axis
    xg = x.float().reshape(*lead, t, c // group_size, group_size)
    scale, zero = _minmax_params(xg, bits, dim=-1, eff=eff)
    q = _clip(torch.round(xg / scale + zero), bits, eff).reshape(*lead, t, c)
    codes = packing.pack(q.to(torch.uint8), bits)
    return QuantizedTensor(codes, scale[..., 0].to(x.dtype), zero[..., 0].to(x.dtype),
                           None, bits, tuple(x.shape))


def quantize_raw16(x: torch.Tensor) -> QuantizedTensor:
    """Identity 'quantization': raw storage wrapped in the same API."""
    return QuantizedTensor(x, None, None, None, 16, tuple(x.shape))


def channel_norm_scale(x: torch.Tensor) -> torch.Tensor:
    """CSTQuant channel normalizer c_i = sqrt(max|X_i|) (paper Eq. 6)."""
    amax = x.float().abs().amax(dim=-2, keepdim=True)
    return correctly_rounded_sqrt(amax.clamp_min(_EPS))


def correctly_rounded_sqrt(x: torch.Tensor) -> torch.Tensor:
    """f32 sqrt rounded to nearest, as the reference computes it.  The CPU's
    vectorized f32 sqrt is off by an ulp at times; a float64 sqrt rounded
    once to f32 is exact."""
    return torch.sqrt(x.double()).float()


def quantize_cst(x: torch.Tensor, bits: int, channel_scale: Optional[torch.Tensor] = None,
                 eff=None) -> QuantizedTensor:
    """Channel-separable tokenwise quantization (paper Alg. 1): normalize each
    channel by c, tokenwise-quantize, and multiply c back at dequantization."""
    xf = x.float()
    c = channel_norm_scale(xf) if channel_scale is None else channel_scale.float()
    xn = xf / c
    scale, zero = _minmax_params(xn, bits, dim=-1, eff=eff)
    codes = _encode(xn, scale, zero, bits, eff=eff)
    return QuantizedTensor(codes, scale.to(x.dtype), zero.to(x.dtype), c.to(x.dtype),
                           bits, tuple(x.shape))


_SCHEMES = {
    "tokenwise": quantize_tokenwise,
    "channelwise": quantize_channelwise,
    "groupwise": quantize_groupwise,
    "cst": quantize_cst,
}


def quantize(x: torch.Tensor, bits: int, scheme: str, **kw) -> QuantizedTensor:
    try:
        fn = _SCHEMES[scheme]
    except KeyError:
        raise ValueError(f"unknown scheme {scheme!r}; one of {sorted(_SCHEMES)}") from None
    return fn(x, bits, **kw)


def fake_quant(x: torch.Tensor, bits: int, scheme: str, **kw) -> torch.Tensor:
    """Quantize + dequantize round trip (the quality-evaluation paths)."""
    return quantize(x, bits, scheme, **kw).dequantize().to(x.dtype)


# ---------------------------------------------------------------------------
# Compression-ratio algebra (paper Appendix A): host arithmetic, the
# reference's operations in its order, so the floats are equal.
# ---------------------------------------------------------------------------

def param_count(scheme: str, b: int, h: int, l: int, d: int, group_size: int = 32) -> int:
    """fp16 quantization parameters for quantizing K *and* V (b batch, h
    heads, l tokens, d head dim; h * d flattened channels)."""
    hd = h * d
    if scheme == "groupwise":
        return 4 * b * hd * l // group_size   # 2 tensors x 2 params x groups
    if scheme == "tokenwise":
        return 4 * b * l
    if scheme == "channelwise_k_tokenwise_v":
        return 2 * hd + 2 * b * l
    if scheme == "zipcache_baseline":         # channelwise K + CST V (paper Table 1)
        return 3 * hd + 2 * b * l
    raise ValueError(scheme)


def compression_ratio(scheme: str, bits: int, b: int, h: int, l: int, d: int,
                      group_size: int = 32, fp_bits: int = 16) -> float:
    """KV compression ratio with the parameter overhead (paper Eq. A-C)."""
    hd = h * d
    total_fp = 2 * b * hd * l * fp_bits
    payload = 2 * b * hd * l * bits
    overhead = param_count(scheme, b, h, l, d, group_size) * fp_bits
    return total_fp / (payload + overhead)


def mixed_precision_ratio(high_bits: int, low_bits: int, saliency_ratio: float, b: int, h: int,
                          l: int, d: int, fp_bits: int = 16,
                          param_scheme: str = "zipcache_baseline", fp_window: int = 0,
                          evict: bool = False) -> float:
    """Compression ratio of the mixed-precision, windowed and eviction
    policies (paper Table 3 / A / B): ZipCache and MiKV put r% of the
    tokens at high_bits and the rest at low_bits; KIVI the last fp_window
    at fp16 and the rest at low_bits; H2O keeps r% at fp16 and evicts the
    rest (no parameters); GEAR has high_bits == low_bits."""
    hd = h * d
    total_fp = 2.0 * b * hd * l * fp_bits
    l_hi = saliency_ratio * l
    l_lo = l - l_hi
    if evict:
        payload = 2.0 * b * hd * l_hi * fp_bits
        overhead = 0.0
    elif fp_window:
        l_w = min(fp_window, l)
        payload = 2.0 * b * hd * (l_w * fp_bits + (l - l_w) * low_bits)
        overhead = param_count(param_scheme, b, h, int(l - l_w), d) * fp_bits
    else:
        payload = 2.0 * b * hd * (l_hi * high_bits + l_lo * low_bits)
        overhead = param_count(param_scheme, b, h, l, d) * fp_bits
    return total_fp / (payload + overhead)
