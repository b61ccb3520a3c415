"""Mixed-precision quantized KV cache (port of `repro.core.kvcache`, mixed
layout: the lockstep path and what continuous batching needs of it).

  MixedKVCache
    ├── hi : TokenStore   — salient tokens at high_bits   (capacity S_hi)
    ├── lo : TokenStore   — regular tokens at low_bits    (capacity S_lo)
    ├── window            — raw staging buffer for freshly decoded tokens,
    │                       folded into hi/lo every `recompress_interval`
    │                       steps (paper Alg. 3)
    └── saliency state    — per-slot accumulated probe mass `acc` and probe
                            counts `nnz` (Eq. 8 numerator / denominator)

Token layout inside a store: (batch, kv_heads, slots, head_dim); pos, acc
and nnz are per (batch, slot).  Empty slots carry pos == -1.  Functions
return new caches and never write into their inputs, like the reference.

Continuous batching: `append_token(active=)` masks empty slots,
`update_probe_state` takes per-row probe flags, `insert_slot`/`free_slot`
write one batch row, and `recompress(rows=)` folds a subset of rows.

Every policy of `CompressionConfig.preset` runs on the same structure with
its own capacities: zipcache and mikv split tokens by saliency into hi and
lo; fp16 keeps every token raw in hi; gear quantizes every token into lo;
kivi keeps its last `fp_window` tokens raw in the window and the rest in
lo; h2o keeps its salient tokens raw in hi and evicts the rest (a
zero-capacity lo).  `use_kernel` builds ZipCache's stores (K channelwise, V
CST, quantized) with one `cst_quant` launch each, which gathers the store's
tokens and quantizes K and V together (`store_at`).

`attend_decode(impl="int8_algebra")` folds the dequantization parameters of
channelwise K and CST V stores into the attention algebra, so the only
(slots, d) tensors are the unpacked bf16 codes (the reference's decode
lever); a store in another scheme raises.

`eff` (`core.precision.LayerEff`, a precision map and / or a downshift
rung) gives the hi and lo stores effective-bit ceilings inside their
containers; every store takes it through `store_at`, on the kernel route
and the plain route alike.  None is the container widths.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import packing, quant
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.models import common

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# TokenStore
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TokenStore:
    """Fixed-capacity store of quantized (K, V) tokens + saliency state."""

    k: quant.QuantizedTensor     # (b, h_kv, S, d) logical
    v: quant.QuantizedTensor
    pos: torch.Tensor            # (b, S) int32 absolute positions, -1 = empty
    acc: torch.Tensor            # (b, S) f32 accumulated probe attention
    nnz: torch.Tensor            # (b, S) f32 probe counts

    @property
    def capacity(self) -> int:
        return self.pos.shape[-1]

    @property
    def valid(self) -> torch.Tensor:
        return self.pos >= 0

    def dequantize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.k.dequantize(), self.v.dequantize()

    def nbytes_packed(self) -> int:
        return self.k.nbytes_packed() + self.v.nbytes_packed()


def tree_map(fn, tree, *rest):
    """Apply `fn` to every tensor leaf of a cache dataclass tree (and the
    matching leaves of `rest`).  Non-tensor fields (bits, logical shapes,
    sink page ids) and None leaves come from `tree` unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return tree


def tree_leaves(tree):
    """The tensor leaves of a cache dataclass tree, in field order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from tree_leaves(getattr(tree, f.name))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _empty_quant(x: torch.Tensor, bits: int) -> quant.QuantizedTensor:
    """Zero-capacity store: no reductions over the empty token axis."""
    pf = packing.pack_factor(min(bits, 8))
    codes = torch.zeros((*x.shape[:-1], x.shape[-1] // pf), dtype=torch.int8, device=x.device)
    scale = torch.ones((*x.shape[:-2], 0, 1), dtype=torch.float32, device=x.device)
    zero = torch.zeros((*x.shape[:-2], 0, 1), dtype=torch.float32, device=x.device)
    return quant.QuantizedTensor(codes, scale, zero, None, min(bits, 8), tuple(x.shape))


def _quantize_kv(k: torch.Tensor, v: torch.Tensor, bits: int, cfg: CompressionConfig,
                 eff=None):
    """Quantize gathered K/V token blocks per the policy's schemes; eff:
    None or the store's (eff_k, eff_v).  Raw 16-bit stores ignore it."""
    if k.shape[-2] == 0:
        return _empty_quant(k, bits), _empty_quant(v, bits)
    if bits >= 16:
        return quant.quantize_raw16(k), quant.quantize_raw16(v)
    kw_k = {"group_size": min(cfg.group_size, k.shape[-1])} if cfg.key_scheme == "groupwise" else {}
    kw_v = {"group_size": min(cfg.group_size, v.shape[-1])} if cfg.value_scheme == "groupwise" else {}
    eff_k, eff_v = eff if eff is not None else (None, None)
    qk = quant.quantize(k, bits, cfg.key_scheme, eff=eff_k, **kw_k)
    qv = quant.quantize(v, bits, cfg.value_scheme, eff=eff_v, **kw_v)
    return qk, qv


def build_store(k, v, pos, acc, nnz, bits: int, cfg: CompressionConfig,
                eff=None) -> TokenStore:
    qk, qv = _quantize_kv(k, v, bits, cfg, eff=eff)
    return TokenStore(qk, qv, pos.to(torch.int32), acc.float(), nnz.float())


def store_at(k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor, pos, acc, nnz, bits: int,
             cfg: CompressionConfig, use_kernel: bool = False, eff=None) -> TokenStore:
    """The store of the tokens that idx (b, S) picks from k / v (b, h_kv, l,
    d); idx < 0 gives a zero row (a store's padding, an invalid slot).  pos,
    acc and nnz are per slot already.  eff: None or the store's (eff_k,
    eff_v) effective bits.  With `use_kernel`, ZipCache's stores (K
    channelwise, V CST) at a quantized width take one `cst_quant` launch for
    the gather and both quantizers, eff included."""
    if use_kernel and idx.shape[1] and bits < 16 \
            and (cfg.key_scheme, cfg.value_scheme) == ("channelwise", "cst"):
        from repro_torch.kernels.cst_quant import ops as cst_ops
        qk, qv = cst_ops.quantize_store(k, v, idx, bits, eff=eff)
        return TokenStore(qk, qv, pos.to(torch.int32), acc.float(), nnz.float())
    return build_store(_gather_tokens(k, idx), _gather_tokens(v, idx), pos, acc, nnz, bits, cfg,
                       eff=eff)


def _store_effs(eff):
    """(hi, lo) store effs of a `precision.LayerEff` (None: both None)."""
    if eff is None:
        return None, None
    return (eff.hi_k, eff.hi_v), (eff.lo_k, eff.lo_v)


def empty_store(b: int, h_kv: int, capacity: int, d: int, bits: int, cfg: CompressionConfig,
                dtype=torch.bfloat16, d_v: Optional[int] = None, device=None) -> TokenStore:
    k = torch.zeros((b, h_kv, capacity, d), dtype=dtype, device=device)
    v = torch.zeros((b, h_kv, capacity, d_v if d_v is not None else d), dtype=dtype, device=device)
    pos = torch.full((b, capacity), -1, dtype=torch.int32, device=device)
    acc = torch.zeros((b, capacity), dtype=torch.float32, device=device)
    return build_store(k, v, pos, acc, acc.clone(), bits, cfg)


# ---------------------------------------------------------------------------
# MixedKVCache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MixedKVCache:
    hi: TokenStore
    lo: TokenStore
    k_win: torch.Tensor        # (b, h_kv, W, d) raw staging window
    v_win: torch.Tensor
    win_pos: torch.Tensor      # (b, W) int32, -1 empty
    win_acc: torch.Tensor      # (b, W) f32
    win_nnz: torch.Tensor      # (b, W) f32
    length: torch.Tensor       # (b,) int32: tokens seen (next position)
    win_fill: torch.Tensor     # (b,) int32: occupied window slots per row

    @property
    def window(self) -> int:
        return self.win_pos.shape[-1]

    @property
    def capacity(self) -> int:
        return self.hi.capacity + self.lo.capacity + self.window

    def nbytes_packed(self) -> int:
        """Bytes of the KV payload: packed hi/lo stores (codes + quantization
        params) plus the raw staging window."""
        return (self.hi.nbytes_packed() + self.lo.nbytes_packed()
                + _nbytes(self.k_win) + _nbytes(self.v_win))

    def nbytes_total(self) -> int:
        """All leaf bytes, including bookkeeping (pos/acc/nnz/length)."""
        return _nbytes(self)

    def nbytes_overhead(self) -> int:
        return self.nbytes_total() - self.nbytes_packed()


SLOT_ALIGN = 128  # store capacities align to this for caches of >= 2048 tokens


def _align(n: int, a: int, up: bool = False) -> int:
    return ((n + (a - 1 if up else a // 2)) // a) * a


def capacities(cfg: CompressionConfig, max_len: int) -> Tuple[int, int, int]:
    """Static (S_hi, S_lo, W) slot capacities for a max sequence length."""
    a = SLOT_ALIGN if max_len >= 2048 else 1
    w = max(cfg.recompress_interval, 8)
    if cfg.method == "kivi":
        w = w + cfg.fp_window
    w = _align(w, a, up=True) if w else 0
    if cfg.method == "fp16":
        return max_len, 0, w
    if cfg.method == "h2o":
        return max(_align(cfg.n_salient(max_len), a), a), 0, w
    if cfg.method in ("gear", "kivi"):
        return 0, max_len, w
    s_hi = min(max(_align(cfg.n_salient(max_len), a), a), max_len)
    return s_hi, max_len - s_hi, w


def _lo_bits(cfg: CompressionConfig) -> int:
    """The lo store's width: h2o evicts its regular tokens (0 bits), and its
    zero-capacity lo store is declared 2-bit, as the reference's."""
    return max(cfg.low_bits, 2) if cfg.low_bits else 2


def _window(b, h_kv, w, d, dv, dtype, device) -> dict:
    return dict(
        k_win=torch.zeros((b, h_kv, w, d), dtype=dtype, device=device),
        v_win=torch.zeros((b, h_kv, w, dv), dtype=dtype, device=device),
        win_pos=torch.full((b, w), -1, dtype=torch.int32, device=device),
        win_acc=torch.zeros((b, w), dtype=torch.float32, device=device),
        win_nnz=torch.zeros((b, w), dtype=torch.float32, device=device),
        win_fill=torch.zeros((b,), dtype=torch.int32, device=device))


def init_cache(cfg: CompressionConfig, b: int, h_kv: int, d: int, max_len: int,
               dtype=torch.bfloat16, d_v: Optional[int] = None, device=None) -> MixedKVCache:
    dv = d_v if d_v is not None else d
    s_hi, s_lo, w = capacities(cfg, max_len)
    return MixedKVCache(
        hi=empty_store(b, h_kv, s_hi, d, cfg.high_bits, cfg, dtype, d_v=dv, device=device),
        lo=empty_store(b, h_kv, s_lo, d, _lo_bits(cfg), cfg, dtype, d_v=dv, device=device),
        length=torch.zeros((b,), dtype=torch.int32, device=device),
        **_window(b, h_kv, w, d, dv, dtype, device))


# ---------------------------------------------------------------------------
# Prefill compression (paper Alg. 2)
# ---------------------------------------------------------------------------

def _gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (b, h, l, d); idx: (b, n) -> (b, h, n, d), a zero row where idx < 0."""
    b, h, _, d = x.shape
    src = idx.clamp_min(0).long()[:, None, :, None].expand(b, h, idx.shape[1], d)
    rows = torch.gather(x, 2, src)
    return torch.where((idx >= 0)[:, None, :, None], rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _gather_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (b, l); idx: (b, n) -> (b, n)."""
    return torch.gather(x, 1, idx.long())


def compress_prefill(cfg: CompressionConfig, k: torch.Tensor, v: torch.Tensor,
                     token_saliency: Optional[torch.Tensor], max_len: int,
                     probe_nnz: Optional[torch.Tensor] = None, dtype=torch.bfloat16,
                     use_kernel: bool = False, eff=None) -> MixedKVCache:
    """Compress prefill K/V (b, h_kv, l, d) into a MixedKVCache sized max_len.

    token_saliency: (b, l) normalized probe saliency, None for the policies
    without saliency (fp16, gear, kivi); probe_nnz: (b, l) its Eq. 8
    denominators.  `acc` stores the raw mass: saliency * max(nnz, 1).
    eff: optional `precision.LayerEff`, this layer's effective bits (raw
    segments ignore it).
    """
    b, h_kv, l, d = k.shape
    s_hi, s_lo, w = capacities(cfg, max_len)
    dev = k.device
    positions = torch.arange(l, dtype=torch.int32, device=dev).expand(b, l)
    nnz = probe_nnz.float() if probe_nnz is not None else torch.ones((b, l), device=dev)
    sal_ = (token_saliency.float() if token_saliency is not None
            else torch.zeros((b, l), device=dev))
    acc = sal_ * nnz.clamp_min(1.0)
    length = torch.full((b,), l, dtype=torch.int32, device=dev)
    eff_hi, eff_lo = _store_effs(eff)

    def store(idx, capacity, bits, store_eff):
        """The store of tokens idx, right-padded to its static capacity."""
        pad = capacity - idx.shape[1]
        if pad < 0:
            raise ValueError(f"{idx.shape[1]} tokens exceed store capacity {capacity}")

        def slots(x, fill=0):
            return torch.nn.functional.pad(x, (0, pad), value=fill)

        return store_at(k, v, slots(idx, -1), slots(_gather_slots(positions, idx), -1),
                        slots(_gather_slots(acc, idx)), slots(_gather_slots(nnz, idx)), bits,
                        cfg, use_kernel=use_kernel, eff=store_eff)

    def empty(capacity, bits):
        """A store this policy leaves empty (zero capacity)."""
        return empty_store(b, h_kv, capacity, d, bits, cfg, dtype, d_v=v.shape[-1], device=dev)

    def window():
        return _window(b, h_kv, w, d, v.shape[-1], dtype, dev)

    def cache(hi, lo, win=None):
        return MixedKVCache(hi=hi, lo=lo, length=length, **(win or window()))

    if cfg.method == "fp16":
        return cache(store(positions, s_hi, 16, None), empty(s_lo, _lo_bits(cfg)))
    if cfg.method == "gear":
        return cache(empty(s_hi, cfg.high_bits), store(positions, s_lo, cfg.low_bits, eff_lo))
    if cfg.method == "kivi":
        # the last fp_window tokens raw in the window (sized fp_window plus
        # the fold's staging room), the rest in lo at low bits
        n_body = max(l - min(cfg.fp_window, w), 0)
        n_win = l - n_body
        win = window()
        win["k_win"][:, :, :n_win] = k[:, :, n_body:].to(dtype)
        win["v_win"][:, :, :n_win] = v[:, :, n_body:].to(dtype)
        win["win_pos"][:, :n_win] = positions[:, n_body:]
        win["win_fill"].fill_(n_win)
        return cache(empty(s_hi, cfg.high_bits),
                     store(positions[:, :n_body], s_lo, cfg.low_bits, eff_lo), win)

    # saliency policies: zipcache, mikv, h2o
    if token_saliency is None:
        raise ValueError(f"{cfg.method} needs token saliency")
    n_hi = min(cfg.n_salient(l), s_hi)
    salient_idx, regular_idx = sal.salient_split(token_saliency, n_hi)
    hi = store(salient_idx, s_hi, cfg.high_bits, eff_hi)
    if cfg.low_bits == 0:   # h2o: the regular tokens are evicted
        return cache(hi, empty(s_lo, _lo_bits(cfg)))
    return cache(hi, store(regular_idx, s_lo, cfg.low_bits, eff_lo))


# ---------------------------------------------------------------------------
# Decode: attend over the cache, append new token, update probe state
# ---------------------------------------------------------------------------

class DecodeAttnOut(NamedTuple):
    out: torch.Tensor                     # (b, h_q, dv)
    slot_weights: Optional[torch.Tensor]  # (b, S_total) head-pooled, or None


def cache_keys_values(cache: MixedKVCache):
    """Dequantize + concat all segments. Returns (k, v, valid, positions)."""
    k_hi, v_hi = cache.hi.dequantize()
    k_lo, v_lo = cache.lo.dequantize()
    k = torch.cat([k_hi, k_lo, cache.k_win], dim=2)
    v = torch.cat([v_hi, v_lo, cache.v_win], dim=2)
    pos = torch.cat([cache.hi.pos, cache.lo.pos, cache.win_pos], dim=1)
    return k, v, pos >= 0, pos


def attend_decode(q: torch.Tensor, cache: MixedKVCache, scale: Optional[float] = None,
                  impl: str = "ref") -> DecodeAttnOut:
    """One-token decode attention over the mixed cache (exact softmax, with
    head-pooled slot weights).  q: (b, h_q, d).  impl="int8_algebra" folds
    the dequantization into the attention algebra (`attend_decode_int8`)."""
    if impl == "int8_algebra":
        return attend_decode_int8(q, cache, scale)
    if impl != "ref":
        raise ValueError(f"unknown decode impl {impl!r}; one of ('ref', 'int8_algebra')")
    out, w = attend_exact(q, cache, scale)
    return DecodeAttnOut(out, w.mean(dim=(1, 2)))


def attend_exact(q: torch.Tensor, cache: MixedKVCache, scale: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`attend_decode`'s exact route before the head pooling: (out (b, h_q,
    dv) in q's dtype, the softmax weights (b, h_kv, g, S) f32)."""
    k, v, valid, _ = cache_keys_values(cache)
    b, h_kv, _, d = k.shape
    h_q = q.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, h_kv, h_q // h_kv, d).float() * scale
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k.float())
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", w, v.float()).reshape(b, h_q, -1).to(q.dtype)
    return out, w


def _int8_store(store: TokenStore) -> None:
    """The int8 algebra folds channelwise K and CST V parameters: a store
    quantized in another scheme raises, naming it."""
    for name, q, want in (("K", store.k, "channelwise"), ("V", store.v, "cst")):
        got = quant.scheme_of(q)
        if got not in ("raw", want):
            raise ValueError(f"decode_impl='int8_algebra' needs {want} {name} stores (or raw "
                             f"ones); this store's {name} is {got}")


def _codes_product(eq: str, x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """x (f32) against unpacked bf16 codes: a bf16 product (f32 accumulation,
    one rounding to bf16), returned in f32."""
    return common.einsum(eq, x.to(torch.bfloat16), codes).float()


def _store_logits_int8(qg: torch.Tensor, store: TokenStore) -> torch.Tensor:
    """q . dequant(K)^T of a channelwise K store without dequantized K:
        dequant(K)[s, d] = (C[s, d] - zero_c[d]) * scale_c[d]
        logits[s] = sum_d q'[d] C[s, d] - sum_d q[d] scale_c[d] zero_c[d],
    with q' = q * scale_c.  qg (b, hk, g, d) f32 -> (b, hk, g, S) f32."""
    kq = store.k
    if kq.bits >= 16:
        return torch.einsum("bhgd,bhsd->bhgs", qg, kq.dequantize().float())
    codes = packing.unpack(kq.codes, kq.bits, out_dtype=torch.bfloat16)
    scale_c = kq.scale.float()[:, :, 0]               # (b, hk, d)
    zero_c = kq.zero.float()[:, :, 0]
    lin = _codes_product("bhgd,bhsd->bhgs", qg * scale_c[:, :, None, :], codes)
    const = torch.einsum("bhgd,bhd->bhg", qg, scale_c * zero_c)
    return lin - const[..., None]


def _store_values_int8(w: torch.Tensor, store: TokenStore) -> torch.Tensor:
    """w . dequant(V) of a CST V store, its scales folded into the weights:
        V[s, d] = (C[s, d] - zt[s]) * ts[s] * cs[d]
        out[d] = cs[d] (sum_s (w ts)[s] C[s, d] - sum_s w[s] ts[s] zt[s]).
    w (b, hk, g, S) f32 -> (b, hk, g, dv) f32."""
    vq = store.v
    if vq.bits >= 16:
        return torch.einsum("bhgs,bhsd->bhgd", w, vq.dequantize().float())
    codes = packing.unpack(vq.codes, vq.bits, out_dtype=torch.bfloat16)
    ts = vq.scale.float()[..., 0]                     # (b, hk, S)
    zt = vq.zero.float()[..., 0]
    cs = vq.channel_scale.float()[:, :, 0]            # (b, hk, d)
    lin = _codes_product("bhgs,bhsd->bhgd", w * ts[:, :, None, :], codes)
    corr = torch.einsum("bhgs,bhs->bhg", w, ts * zt)
    return (lin - corr[..., None]) * cs[:, :, None, :]


def attend_decode_int8(q: torch.Tensor, cache: MixedKVCache,
                       scale: Optional[float] = None) -> DecodeAttnOut:
    """Decode attention with the dequantization folded into the attention
    algebra: the only (S, d) tensors are the unpacked bf16 codes feeding the
    products (the reference's `attend_decode_int8`).  Same (out,
    slot_weights) as `attend_decode` within bf16 rounding of the products.
    Stores must be channelwise K / CST V (ZipCache's) or raw; empty ones
    are skipped."""
    b, h_q, d = q.shape
    h_kv = cache.k_win.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, h_kv, h_q // h_kv, d).float() * scale
    stores = [s for s in (cache.hi, cache.lo) if s.capacity]
    for store in stores:
        _int8_store(store)
    logits = torch.cat([_store_logits_int8(qg, s) for s in stores]
                       + [torch.einsum("bhgd,bhsd->bhgs", qg, cache.k_win.float())], dim=-1)
    valid = torch.cat([s.valid for s in stores] + [cache.win_pos >= 0], dim=-1)
    w = torch.softmax(logits.masked_fill(~valid[:, None, None, :], NEG_INF), dim=-1)
    out = torch.zeros((b, h_kv, h_q // h_kv, cache.v_win.shape[-1]), dtype=torch.float32,
                      device=q.device)
    off = 0
    for store in stores:
        out = out + _store_values_int8(w[..., off:off + store.capacity], store)
        off += store.capacity
    out = out + torch.einsum("bhgs,bhsd->bhgd", w[..., off:], cache.v_win.float())
    return DecodeAttnOut(out.reshape(b, h_q, -1).to(q.dtype), w.mean(dim=(1, 2)))


def _store_logits_vstream_int8(qv: torch.Tensor, store: TokenStore) -> torch.Tensor:
    """q . dequant(V)^T of a CST V stream (MLA: the latent is the value-scheme
    stream and also the keys of the absorbed attention), the per-channel
    scale folded into q:
        V[s, r] = (C[s, r] - zt[s]) * ts[s] * cs[r]
        logits[s] = ts[s] ((q cs) . C[s]) - ts[s] zt[s] ((q cs) . 1).
    qv (b, hk, g, r) f32 -> (b, hk, g, S) f32."""
    vq = store.v
    if vq.bits >= 16:
        return torch.einsum("bhgr,bhsr->bhgs", qv, vq.dequantize().float())
    codes = packing.unpack(vq.codes, vq.bits, out_dtype=torch.bfloat16)
    ts = vq.scale.float()[..., 0]                     # (b, hk, S)
    zt = vq.zero.float()[..., 0]
    cs = vq.channel_scale.float()[:, :, 0]            # (b, hk, r)
    qc = qv * cs[:, :, None, :]
    lin = _codes_product("bhgr,bhsr->bhgs", qc, codes)
    return ts[:, :, None, :] * lin - (ts * zt)[:, :, None, :] * qc.sum(dim=-1)[..., None]


def attend_decode_mla_int8(q_abs: torch.Tensor, q_pe: torch.Tensor, cache: MixedKVCache,
                           scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absorbed MLA decode with the dequantization folded into the attention
    algebra (the reference's `attend_decode_mla_int8`): the k stream is the
    rope key (b, 1, S, p), channelwise; the v stream the latent (b, 1, S, r),
    CST.  logits = scale (q_abs . latent + q_pe . k_pe); out = softmax .
    latent.  q_abs (b, h, r), q_pe (b, h, p).  Returns (out_latent (b, h, r)
    f32, slot_weights (b, S_total))."""
    b, h, r = q_abs.shape
    qa = q_abs.reshape(b, 1, h, r).float() * scale
    qp = q_pe.reshape(b, 1, h, -1).float() * scale
    stores = [s for s in (cache.hi, cache.lo) if s.capacity]
    for store in stores:
        _int8_store(store)
    logits = torch.cat(
        [_store_logits_vstream_int8(qa, s) + _store_logits_int8(qp, s) for s in stores]
        + [torch.einsum("bhgr,bhsr->bhgs", qa, cache.v_win.float())
           + torch.einsum("bhgp,bhsp->bhgs", qp, cache.k_win.float())], dim=-1)
    valid = torch.cat([s.valid for s in stores] + [cache.win_pos >= 0], dim=-1)
    w = torch.softmax(logits.masked_fill(~valid[:, None, None, :], NEG_INF), dim=-1)
    out = torch.zeros((b, 1, h, r), dtype=torch.float32, device=q_abs.device)
    off = 0
    for store in stores:
        out = out + _store_values_int8(w[..., off:off + store.capacity], store)
        off += store.capacity
    out = out + torch.einsum("bhgs,bhsr->bhgr", w[..., off:], cache.v_win.float())
    return out.reshape(b, h, r), w[:, 0].mean(dim=1)


def any_probe(is_probe) -> bool:
    """Whether any row probes this step: a host bool, or a (b,) tensor that
    the caller passes only when some row probes."""
    return is_probe if isinstance(is_probe, bool) else True


def update_probe_state(cache: MixedKVCache, slot_weights: Optional[torch.Tensor],
                       is_probe) -> MixedKVCache:
    """Fold a probe row's slot weights (hi/lo/window order) into the
    saliency state.

    is_probe: a host bool for the whole batch, or a (b,) device tensor of
    per-row flags (continuous batching: each request probes on its own
    token counter), added as `p[:, None] * w` as the reference does.  A
    step on which no row probes passes False and leaves the state as it
    is (the reference adds 0 * weights)."""
    if isinstance(is_probe, bool):
        if not is_probe:
            return cache
        scaled = lambda x: x  # noqa: E731
    else:
        p = is_probe.float()[:, None]
        scaled = lambda x: p * x  # noqa: E731
    s_hi, s_lo = cache.hi.capacity, cache.lo.capacity
    hi = dataclasses.replace(cache.hi, acc=cache.hi.acc + scaled(slot_weights[:, :s_hi]),
                             nnz=cache.hi.nnz + scaled(cache.hi.valid.float()))
    lo = dataclasses.replace(cache.lo, acc=cache.lo.acc + scaled(slot_weights[:, s_hi:s_hi + s_lo]),
                             nnz=cache.lo.nnz + scaled(cache.lo.valid.float()))
    return dataclasses.replace(
        cache, hi=hi, lo=lo, win_acc=cache.win_acc + scaled(slot_weights[:, s_hi + s_lo:]),
        win_nnz=cache.win_nnz + scaled((cache.win_pos >= 0).float()))


def _append_cursor(cache, active: Optional[torch.Tensor]):
    """(write mask, clamped window slot, counter increment) of one append.
    A row whose window is full, or that `active` masks, drops the write
    (the reference's out-of-bounds `mode="drop"`); masked rows also keep
    their counters."""
    w = cache.window
    fill = cache.win_fill
    inc = torch.ones_like(fill)
    if active is not None:
        fill = torch.where(active, fill, w)
        inc = active.to(fill.dtype)
    return fill < w, fill.clamp(max=w - 1).long(), inc


def _advance(cache, inc: torch.Tensor, writes: torch.Tensor, slot: torch.Tensor) -> dict:
    """The bookkeeping half of an append: window position + counters."""
    bidx = torch.arange(cache.win_pos.shape[0], device=slot.device)
    win_pos = cache.win_pos.clone()
    win_pos[bidx, slot] = torch.where(writes, cache.length, win_pos[bidx, slot])
    return dict(win_pos=win_pos, length=cache.length + inc, win_fill=cache.win_fill + inc)


def append_token(cache: MixedKVCache, k_t: torch.Tensor, v_t: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> MixedKVCache:
    """Append one decoded token's K/V (b, h_kv, d) at each row's window
    cursor.  A row whose window is full drops the write but still advances
    its counters; rows where `active` ((b,) bool) is False write nothing
    and keep their counters (empty or retired slots)."""
    writes, slot, inc = _append_cursor(cache, active)
    bidx = torch.arange(k_t.shape[0], device=k_t.device)
    k_win = cache.k_win.clone()
    v_win = cache.v_win.clone()
    for win, x in ((k_win, k_t), (v_win, v_t)):
        win[bidx, :, slot] = torch.where(writes[:, None, None], x.to(win.dtype),
                                         win[bidx, :, slot])
    return dataclasses.replace(cache, k_win=k_win, v_win=v_win,
                               **_advance(cache, inc, writes, slot))


# ---------------------------------------------------------------------------
# Slot-based batch insertion (continuous batching)
# ---------------------------------------------------------------------------

def _row_set(t: torch.Tensor, slot: int, value) -> torch.Tensor:
    out = t.clone()
    out[slot] = value
    return out


def tree_update_rows(dst, src, slot: int):
    """Write `src` (batch 1 in every leaf) into batch row `slot` of `dst`.
    Non-tensor fields (a QuantizedTensor's logical shape) keep dst's."""
    return tree_map(lambda d, s: _row_set(d, slot, s[0].to(d.dtype)), dst, src)


def insert_slot(dst: MixedKVCache, src: MixedKVCache, slot: int) -> MixedKVCache:
    """Write a 1-request cache slice `src` (batch 1, same capacities) into
    batch row `slot` of `dst`."""
    return tree_update_rows(dst, src, slot)


def free_slot(cache, slot: int):
    """Retire batch row `slot`: invalidate its positions and zero its
    counters.  Stale payload stays in place: validity is pos-driven.
    Metadata-only, so it applies to the paged layout unchanged."""
    def store(s):
        return dataclasses.replace(s, pos=_row_set(s.pos, slot, -1), acc=_row_set(s.acc, slot, 0),
                                   nnz=_row_set(s.nnz, slot, 0))

    return dataclasses.replace(
        cache, hi=store(cache.hi), lo=store(cache.lo), win_pos=_row_set(cache.win_pos, slot, -1),
        win_acc=_row_set(cache.win_acc, slot, 0), win_nnz=_row_set(cache.win_nnz, slot, 0),
        length=_row_set(cache.length, slot, 0), win_fill=_row_set(cache.win_fill, slot, 0))


def tree_select_rows(mask: torch.Tensor, new_tree, old_tree):
    """Per-row select between two same-shaped trees: rows where `mask`
    ((b,) bool) is set take `new_tree`."""
    def sel(n, o):
        return torch.where(mask.reshape(mask.shape + (1,) * (n.dim() - 1)), n, o)

    return tree_map(sel, new_tree, old_tree)


# ---------------------------------------------------------------------------
# Streaming recompression (paper Alg. 3)
# ---------------------------------------------------------------------------

def recompress(cfg: CompressionConfig, cache: MixedKVCache, rows: Optional[torch.Tensor] = None,
               use_kernel: bool = False, eff=None) -> MixedKVCache:
    """Fold the staging window back into the quantized stores: re-rank every
    valid token by its current saliency (acc / nnz for 'normalized', acc for
    'accumulated'; by position for fp16, gear and kivi), rebuild hi/lo,
    empty the window.  h2o keeps half its raw hi store for the most recent
    tokens and fills the rest with heavy hitters; kivi's fold, like the
    reference's, leaves no token raw (its window empties into lo).

    rows: optional (b,) bool: fold only those rows (each slot of a
    continuous batch folds on its own counter).  Every step is
    row-independent, so selecting rows afterwards is exact.

    eff: optional `precision.LayerEff` of the rebuilt stores (a precision
    map, possibly with a per-slot downshift rung folded in by
    `precision.rung_eff`)."""
    new = _recompress_all(cfg, cache, use_kernel=use_kernel, eff=eff)
    return new if rows is None else tree_select_rows(rows, new, cache)


def _valid_first(idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Order gathered slot indices so VALID tokens form a contiguous prefix
    (valid in ascending index order, then invalid ones likewise)."""
    s_total = valid.shape[-1]
    key = torch.where(_gather_slots(valid, idx), idx, idx + s_total)
    return (torch.sort(key, dim=-1).values % s_total).to(torch.int32)


def _top(scores: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the n largest scores per row, ties lower index first, as
    `jax.lax.top_k` (and the reference's stable `argsort(-scores)`) ranks."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :n].to(torch.int32)


def _recompress_all(cfg: CompressionConfig, cache: MixedKVCache,
                    use_kernel: bool = False, eff=None) -> MixedKVCache:
    k, v, valid, pos = cache_keys_values(cache)
    acc = torch.cat([cache.hi.acc, cache.lo.acc, cache.win_acc], dim=1)
    nnz = torch.cat([cache.hi.nnz, cache.lo.nnz, cache.win_nnz], dim=1)
    if cfg.method == "fp16" or cfg.saliency_metric not in ("normalized", "accumulated"):
        scores = pos.float()           # fp16, gear, kivi: by recency, newest first
    elif cfg.saliency_metric == "normalized":
        scores = acc / nnz.clamp_min(1.0)
    else:
        scores = acc
    scores = scores.masked_fill(~valid, NEG_INF)
    s_hi, s_lo = cache.hi.capacity, cache.lo.capacity
    eff_hi, eff_lo = _store_effs(eff)

    def store(idx_, bits, store_eff):
        order = _valid_first(idx_, valid)
        # invalid slots read a zero row: channel scales reduce over the whole
        # token axis, so stale payload would leak into live tokens' scales
        src = torch.where(_gather_slots(valid, order), order, -1)
        return store_at(k, v, src, _gather_slots(pos, order), _gather_slots(acc, order),
                        _gather_slots(nnz, order), bits, cfg, use_kernel=use_kernel,
                        eff=store_eff)

    if cfg.method == "h2o":
        # H2O's retention: the s_hi // 2 most recent tokens (+1e30 on their
        # scores), then the heavy hitters by accumulated score; all raw
        recency = pos.float().masked_fill(~valid, NEG_INF)
        keep = torch.zeros_like(scores).scatter_(1, _top(recency, s_hi // 2).long(), -NEG_INF)
        hi = store(_top(scores + keep, s_hi), 16, None)
        return _emptied_window(dataclasses.replace(cache, hi=hi))
    idx = _top(scores, s_hi + s_lo)
    hi = store(idx[:, :s_hi], cfg.high_bits, eff_hi)
    lo = store(idx[:, s_hi:], cfg.low_bits, eff_lo)
    return _emptied_window(dataclasses.replace(cache, hi=hi, lo=lo))


def _emptied_window(cache: MixedKVCache) -> MixedKVCache:
    return dataclasses.replace(
        cache,
        k_win=torch.zeros_like(cache.k_win), v_win=torch.zeros_like(cache.v_win),
        win_pos=torch.full_like(cache.win_pos, -1), win_acc=torch.zeros_like(cache.win_acc),
        win_nnz=torch.zeros_like(cache.win_nnz), win_fill=torch.zeros_like(cache.win_fill))
