"""Per-layer/per-head precision maps and the downshift rung algebra (port of
`repro.core.precision`).

A `PrecisionMap` gives every (layer, head) a `(nbits_key, nbits_value)`
pair that acts as a CEILING on the bits the quantizer spends.  Storage
containers are untouched: the cache still packs codes at the policy's
`high_bits` / `low_bits` widths, so every cache shape, page table and
kernel launch is map-independent.  The map lowers the EFFECTIVE width
inside the quantizers by shrinking qmax to ``2**eff - 1``; scale and zero
absorb the coarser grid, dequantization is unchanged, and an entry at or
above the container width is bitwise the unmapped path.

Two spec syntaxes, both parsed by `parse_precision_map`:

  compact rules   ``default=k8v8;layer:0-1=k8v8;layer:2-:head:0-1=k2v2``
                  (later rules override earlier; ranges are inclusive,
                  ``N-`` means "to the end")
  JSON (KVTuner)  ``{"2": {"0": {"nbits_key": 2, "nbits_value": 2}}}``
                  (layer -> head -> bits, with layer-level entries and a
                  "default" key also accepted)

The downshift ladder reuses the same algebra: a slot's rung r lowers its
lo-store effective bits to ``max(1, lo_eff - r)`` at its next fold, with
the rung a data operand of the fold (one fold routine serves every rung).

Parsing and resolution are numpy/stdlib only; `layer_eff` and `rung_eff`
build f32 torch tensors on the device the caller names.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

# bits above any supported container width: the "no ceiling" sentinel.  A
# raw (>= RAW_BITS) store is never quantized, so the map cannot touch it.
RAW_BITS = 16


class LayerEff(NamedTuple):
    """Effective bits of one layer's hi/lo stores, broadcast-ready.

    Each field is None (the container width: the static-qmax path) or an
    f32 tensor that broadcasts against the (b, h, S, d) tensors handed to
    `quant.quantize`: (h, 1, 1) for a per-head map, (b, h, 1, 1) or
    (b, 1, 1, 1) once a per-slot rung is folded in, () for a bare width.
    """
    hi_k: Optional[torch.Tensor] = None
    hi_v: Optional[torch.Tensor] = None
    lo_k: Optional[torch.Tensor] = None
    lo_v: Optional[torch.Tensor] = None


def _parse_range(tok: str, what: str) -> Tuple[int, Optional[int]]:
    """``N`` | ``N-M`` | ``N-`` -> (start, stop inclusive or None)."""
    try:
        if "-" not in tok:
            n = int(tok)
            return n, n
        lo, hi = tok.split("-", 1)
        return int(lo), (int(hi) if hi else None)
    except ValueError:
        raise ValueError(f"precision map: bad {what} range {tok!r} "
                         "(want N, N-M, or N-)") from None


def _check_bits(k: int, v: int, where: str) -> Tuple[int, int]:
    for b in (k, v):
        if not 1 <= b <= RAW_BITS:
            raise ValueError(f"precision map: bits {b} out of range [1, {RAW_BITS}] {where}")
    return k, v


def _parse_bits(tok: str) -> Tuple[int, int]:
    """``k4v2`` -> (4, 2)."""
    t = tok.strip().lower()
    if not t.startswith("k") or "v" not in t:
        raise ValueError(f"precision map: bad bits spec {tok!r} (want kNvM, e.g. k4v2)")
    k_s, v_s = t[1:].split("v", 1)
    try:
        k, v = int(k_s), int(v_s)
    except ValueError:
        raise ValueError(f"precision map: bad bits spec {tok!r}") from None
    return _check_bits(k, v, f"in {tok!r}")


@dataclass(frozen=True)
class _Rule:
    layers: Tuple[int, Optional[int]]           # inclusive; None = open end
    heads: Optional[Tuple[int, Optional[int]]]  # None = all heads
    bits: Tuple[int, int]                       # (nbits_key, nbits_value)


@dataclass(frozen=True)
class PrecisionMap:
    """Parsed, order-preserving precision rules.  `resolve` makes the (L, h, 2)
    ceiling table of a concrete model shape."""
    default: Tuple[int, int]
    rules: Tuple[_Rule, ...]
    spec: str

    def resolve(self, n_layers: int, n_heads: int) -> np.ndarray:
        """-> int32 (n_layers, n_heads, 2) of (nbits_key, nbits_value)
        ceilings; later rules override earlier ones."""
        table = np.full((n_layers, n_heads, 2), self.default, dtype=np.int32)
        for r in self.rules:
            l0, l1 = r.layers
            l1 = n_layers - 1 if l1 is None else min(l1, n_layers - 1)
            if l0 > l1:
                continue
            h0, h1 = (0, n_heads - 1) if r.heads is None else r.heads
            h1 = n_heads - 1 if h1 is None else min(h1, n_heads - 1)
            if h0 > h1:
                continue
            table[l0:l1 + 1, h0:h1 + 1] = r.bits
        return table


def _parse_json(spec: str) -> PrecisionMap:
    try:
        obj = json.loads(spec)
    except json.JSONDecodeError as e:
        raise ValueError(f"precision map: invalid JSON: {e}") from None
    if not isinstance(obj, dict):
        raise ValueError("precision map: JSON spec must be an object "
                         "{layer: {head: {nbits_key, nbits_value}}}")

    def bits_of(d, where) -> Tuple[int, int]:
        if not isinstance(d, dict) or "nbits_key" not in d or "nbits_value" not in d:
            raise ValueError(f"precision map: {where} must be "
                             "{'nbits_key': K, 'nbits_value': V}")
        return _check_bits(int(d["nbits_key"]), int(d["nbits_value"]), f"at {where}")

    default = (RAW_BITS, RAW_BITS)
    rules = []
    for key, val in obj.items():
        if key == "default":
            default = bits_of(val, "default")
            continue
        try:
            layer = int(key)
        except ValueError:
            raise ValueError(f"precision map: layer key {key!r} is not an integer "
                             "(or 'default')") from None
        if isinstance(val, dict) and "nbits_key" in val:
            rules.append(_Rule((layer, layer), None, bits_of(val, f"layer {layer}")))
            continue
        if not isinstance(val, dict):
            raise ValueError(f"precision map: layer {layer} entry must be an object")
        for hkey, hval in val.items():
            try:
                head = int(hkey)
            except ValueError:
                raise ValueError(f"precision map: head key {hkey!r} under layer {layer} is "
                                 "not an integer") from None
            rules.append(_Rule((layer, layer), (head, head),
                               bits_of(hval, f"layer {layer} head {head}")))
    return PrecisionMap(default=default, rules=tuple(rules), spec=spec)


def _parse_compact(spec: str) -> PrecisionMap:
    default = (RAW_BITS, RAW_BITS)
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"precision map: rule {part!r} has no '=' "
                             "(want default=kNvM or layer:RANGE=kNvM)")
        sel, bits_s = part.rsplit("=", 1)
        bits = _parse_bits(bits_s)
        sel = sel.strip().lower()
        if sel == "default":
            default = bits
            continue
        toks = sel.split(":")
        if toks[0] != "layer" or len(toks) not in (2, 4) \
                or (len(toks) == 4 and toks[2] != "head"):
            raise ValueError(f"precision map: bad selector {sel!r} (want default, "
                             "layer:RANGE, or layer:RANGE:head:RANGE)")
        layers = _parse_range(toks[1], "layer")
        heads = _parse_range(toks[3], "head") if len(toks) == 4 else None
        rules.append(_Rule(layers, heads, bits))
    return PrecisionMap(default=default, rules=tuple(rules), spec=spec)


def parse_precision_map(spec: Optional[str]) -> Optional[PrecisionMap]:
    """Spec string -> PrecisionMap; None or blank -> None (maps off, the
    bitwise-default path).  Raises ValueError on a malformed spec, which the
    CLI turns into an argparse error."""
    if spec is None or not spec.strip():
        return None
    spec = spec.strip()
    return _parse_json(spec) if spec.startswith("{") else _parse_compact(spec)


def pooled_table(table: np.ndarray, n_heads: int) -> np.ndarray:
    """Adapt a resolved (L, H, 2) table to a cache of `n_heads` heads by
    min-pooling over head groups (a cache with fewer heads honours the
    strictest ceiling of each group); the global min where H does not
    divide evenly."""
    n_layers, h, _ = table.shape
    if h == n_heads:
        return table
    if n_heads < h and h % n_heads == 0:
        return table.reshape(n_layers, n_heads, h // n_heads, 2).min(axis=2)
    return np.broadcast_to(table.min(axis=1, keepdims=True), (n_layers, n_heads, 2)).copy()


def layer_eff(table: np.ndarray, layer: int, high_bits: int, low_bits: int,
              device=None) -> LayerEff:
    """Effective bits of one layer's four quantized stores: (h, 1, 1) f32
    tensors on `device`, ``eff = max(1, min(container, ceiling))``.  Raw
    (>= RAW_BITS) containers ignore the map at the call sites."""
    row = torch.as_tensor(np.asarray(table, dtype=np.int32)[layer], device=device)  # (h, 2)
    ceil_k = row[:, 0].float()[:, None, None]
    ceil_v = row[:, 1].float()[:, None, None]

    def eff(container, ceil):
        return torch.clamp(torch.clamp(ceil, max=float(container)), min=1.0)

    return LayerEff(hi_k=eff(high_bits, ceil_k), hi_v=eff(high_bits, ceil_v),
                    lo_k=eff(low_bits, ceil_k), lo_v=eff(low_bits, ceil_v))


def rung_eff(eff: Optional[LayerEff], rung, high_bits: int, low_bits: int) -> LayerEff:
    """Fold a downshift rung into a layer's effective bits.

    rung: an int tensor, scalar or (b,) (-> (b, 1, 1, 1)), on the cache's
    device.  Only the lo (non-salient) stores downshift, ``lo_eff = max(1,
    base - rung)``; the salient tokens keep their bits.  With `eff` None the
    bases are the container widths.
    """
    r = rung.float()
    if r.dim() == 1:
        r = r[:, None, None, None]
    if eff is None:
        def full(bits):
            return torch.full((), float(bits), dtype=torch.float32, device=r.device)
        eff = LayerEff(full(high_bits), full(high_bits), full(low_bits), full(low_bits))
    return LayerEff(hi_k=eff.hi_k, hi_v=eff.hi_v,
                    lo_k=torch.clamp(eff.lo_k - r, min=1.0),
                    lo_v=torch.clamp(eff.lo_v - r, min=1.0))


def effective_bits(table: Optional[np.ndarray], high_bits: int,
                   low_bits: int) -> Dict[str, float]:
    """Mean effective hi/lo bits under a resolved table (None = no map):
    the bytes accounting of a map.  Container bytes do not change."""
    if table is None:
        return {"hi_bits": float(high_bits), "lo_bits": float(low_bits)}
    t = table.astype(np.float64)
    return {"hi_bits": float(np.minimum(high_bits, t).clip(1).mean()),
            "lo_bits": float(np.minimum(low_bits, t).clip(1).mean())}
