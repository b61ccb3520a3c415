"""Sub-byte packing for quantized KV caches (port of `repro.core.packing`).

``pack_factor = 8 // bits`` consecutive elements of the last axis share one
int8 byte, little-endian within the byte:

    byte = sum_j code[..., i*pf + j] << (bits * j)
"""

from __future__ import annotations

import torch


def pack_factor(bits: int) -> int:
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"unsupported bit-width {bits}")
    return 8 // bits


def packed_dim(dim: int, bits: int) -> int:
    pf = pack_factor(bits)
    if dim % pf:
        raise ValueError(f"last dim {dim} not divisible by pack factor {pf}")
    return dim // pf


def _shifts(bits: int, device) -> torch.Tensor:
    return torch.arange(pack_factor(bits), dtype=torch.int32, device=device) * bits


def pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned integer codes (values < 2**bits) to int8.

    codes: (..., d) -> (..., d // pack_factor) int8.
    """
    pf = pack_factor(bits)
    c = codes.to(torch.int32)
    if pf == 1:
        return c.to(torch.uint8).view(torch.int8)
    out_d = packed_dim(codes.shape[-1], bits)
    c = c.reshape(*codes.shape[:-1], out_d, pf)
    word = (c << _shifts(bits, codes.device)).sum(-1)  # disjoint fields: sum == or
    return word.to(torch.uint8).view(torch.int8)


def unpack(packed: torch.Tensor, bits: int, out_dtype=torch.int32) -> torch.Tensor:
    """Unpack int8 lanes back to integer codes.

    packed: (..., d_packed) int8 -> (..., d_packed * pack_factor) out_dtype.
    """
    pf = pack_factor(bits)
    w = packed.view(torch.uint8).to(torch.int32)
    if pf == 1:
        return w.to(out_dtype)
    fields = (w[..., None] >> _shifts(bits, packed.device)) & ((1 << bits) - 1)
    return fields.reshape(*packed.shape[:-1], packed.shape[-1] * pf).to(out_dtype)
