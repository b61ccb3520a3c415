"""Attention mixers (port of `repro.models.attention`): GQA, and MLA
(DeepSeek-V2) materialized for prefill and absorbed for decode.

Prefill runs blocked causal attention with the ZipCache probe side-output:
the per-column sum of softmax probabilities over probe rows, averaged over
heads (paper Eq. 9).  `blocked_attention` is the reference's jnp path in
PyTorch (with its `compact` bf16 variant); with `use_kernel` it routes to
`kernels.probe_flash`.
MLA's prefill attends with q/k head dim nope + rope and v head dim
v_head_dim (the kernel route takes dv != d); its cache streams are the rope
key (b, 1, l, p) as K and the latent (b, 1, l, r) as V.  MLA decode is
plain PyTorch over the cache's mixed-layout view (`backend.dense`): exact
(`impl="ref"`) or with the dequantization folded into the algebra
(`"int8_algebra"`, `kvcache.attend_decode_mla_int8`).
Shapes: activations (b, l, e); heads (b, h, l, d).

On a mesh (`models.parallel`) a weight split over `model` holds this
rank's block of heads: q, k and v are column-parallel and `wo` row-parallel
(its partial outputs summed over `model`).  Where the kv heads do not split
(their count does not divide the axis) each rank computes every kv head and
keeps those of its query heads (`_local_kv`).  Where the query heads do not
split either, the layer runs whole on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant
from repro_torch.core import saliency as sal
from repro_torch.models import common, parallel
from repro_torch.models.common import ParamDef

NEG_INF = -1e30


def gqa_schema(cfg: ArchConfig) -> dict:
    e, h, hk, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {       # split: heads over `model` on a mesh
        "wq": ParamDef((e, h, d), ("embed", "heads", "head_dim")),
        "wk": ParamDef((e, hk, d), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((e, hk, d), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((h, d, e), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamDef((h, d), ("heads", "head_dim"), init="zeros")
        s["bk"] = ParamDef((hk, d), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = ParamDef((hk, d), ("kv_heads", "head_dim"), init="zeros")
    return common.computed_split(s)


def mla_schema(cfg: ArchConfig) -> dict:
    e, h = cfg.d_model, cfg.n_heads
    r, p, nd, vd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    return common.computed_split({       # heads over `model` on a mesh
        "w_dkv": ParamDef((e, r), ("embed", "latent")),          # down-projection to the latent
        "w_kpe": ParamDef((e, p), ("embed", "rope_dim")),          # the shared rope key
        "w_q_nope": ParamDef((e, h, nd), ("embed", "heads", "head_dim")),
        "w_q_pe": ParamDef((e, h, p), ("embed", "heads", "rope_dim")),
        "w_uk": ParamDef((r, h, nd), ("latent", "heads", "head_dim")),       # up-projection of the keys
        "w_uv": ParamDef((r, h, vd), ("latent", "heads", "v_dim")),       # up-projection of the values
        "wo": ParamDef((h, vd, e), ("heads", "v_dim", "embed")),
        "kv_norm": ParamDef((r,), ("latent",), init="ones"),
    })


class AttnAux(NamedTuple):
    k: torch.Tensor                      # (b, h_kv, l, d) post-rotary keys
    v: torch.Tensor                      # (b, h_kv, l, d)
    saliency: Optional[torch.Tensor]     # (b, l) normalized probe saliency
    probe_nnz: Optional[torch.Tensor]    # (b, l) Eq. 8 denominators


def _probe_row_mask(probe: Optional[sal.ProbeSpec], lq: int, device) -> Optional[torch.Tensor]:
    """(lq,) f32 with 1.0 on probe rows: a repeated position counts once."""
    if probe is None:
        return None
    mask = torch.zeros((lq,), dtype=torch.float32, device=device)
    mask[probe.positions.to(device).long()] = 1.0
    return mask


def blocked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    q_block: int = 512, probe: Optional[sal.ProbeSpec] = None, use_kernel: bool = False,
    compact: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q (b,h,lq,d), k/v (b,h_kv,lkv,d) -> (out, probe_colsum (b, lkv) | None).

    A loop over q blocks; every block sees the full K/V, so each row's
    softmax closes inside its block (float32 scores and probabilities).

    compact=True materializes each block's logits and probabilities in
    bf16 (the softmax statistics still reduce in f32): half the traffic of
    the f32 route, probabilities in [0, 1] within 1e-2.  The kernel route
    (`use_kernel`) takes precedence, as in the reference.

    Under autograd (the training forward) each block runs under
    `torch.utils.checkpoint`: the backward pass recomputes its logits.
    """
    if use_kernel:
        from repro_torch.kernels.probe_flash import ops as pf_ops
        return pf_ops.probe_flash_attention(q, k, v, causal=causal, probe=probe)

    b, h, lq, d = q.shape
    hk, lkv = k.shape[1], k.shape[2]
    g = h // hk
    scale = 1.0 / (d ** 0.5)
    nb = -(-lq // q_block)
    pad = nb * q_block - lq
    qp = F.pad(q, (0, 0, 0, pad)) if pad else q
    qp = qp.reshape(b, hk, g, nb, q_block, d)
    probe_rows = _probe_row_mask(probe, lq, q.device)
    if probe_rows is not None and pad:
        probe_rows = F.pad(probe_rows, (0, pad))

    mat = torch.bfloat16 if compact else torch.float32
    kf = k.to(mat)
    vf = v.to(mat).float()     # compact: V in bf16, its products accumulate in f32
    col = torch.arange(lkv, device=q.device)

    def block(i: int, qi: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor):
        """q block i's output (q's dtype) and its probe column sums (or None)."""
        row = i * q_block + torch.arange(q_block, device=q.device)
        qb = (qi.float() * scale).to(mat)
        logits = common.einsum("bhgqd,bhkd->bhgqk", qb, kf)    # in mat
        if causal:
            logits = logits.masked_fill(row[:, None] < col[None, :], NEG_INF)
        if compact:
            lf = logits.float()
            probs = torch.exp(lf - lf.amax(dim=-1, keepdim=True)).to(torch.bfloat16).float()
            denom = probs.sum(dim=-1, keepdim=True)
            out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vf) / denom
            probs = probs / denom
        else:
            probs = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vf)
        part = None
        if probe_rows is not None:
            pr = probe_rows[i * q_block:(i + 1) * q_block]
            part = quant.true_div(torch.einsum("bhgqk,q->bk", probs, pr), h)
        return out.to(q.dtype), part

    # under autograd each block is recomputed in the backward pass, as the
    # reference's jax.checkpoint(block): no block's logits are kept
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    colsum = torch.zeros((b, lkv), dtype=torch.float32, device=q.device)
    outs = []
    for i in range(nb):
        args = (i, qp[:, :, :, i], kf, vf)
        out, part = (checkpoint(block, *args, use_reentrant=False) if remat else block(*args))
        outs.append(out)
        if part is not None:
            colsum = colsum + part
    dv = outs[0].shape[-1]
    out = torch.stack(outs, dim=3).reshape(b, h, nb * q_block, dv)[:, :, :lq]
    return out, (colsum if probe_rows is not None else None)


def probe_saliency_from_colsum(colsum: torch.Tensor, probe: sal.ProbeSpec, lkv: int,
                               causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize probe column sums into Eq. 8 saliency + its denominators
    (nnz counts every probe position, repeats included, as the reference)."""
    pos = probe.positions.to(colsum.device)
    if causal:
        col = torch.arange(lkv, device=colsum.device)
        nnz = (pos[:, None] >= col[None, :]).float().sum(dim=0)
    else:
        nnz = torch.full((lkv,), float(pos.shape[0]), device=colsum.device)
    return colsum / nnz.clamp_min(1.0), nnz.expand_as(colsum)


def _qkv(params: dict, x: torch.Tensor, eq: str):
    q = common.einsum(eq, x, params["wq"])
    k = common.einsum(eq, x, params["wk"])
    v = common.einsum(eq, x, params["wv"])
    return q, k, v


def _local_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int, h_loc: int, mesh):
    """Every kv head's k / v (b, hk, l, d), computed alike on each model
    rank -> the kv heads of this rank's h_loc query heads: a block of kv
    heads where the local query heads cover whole groups, else one kv head
    per query head."""
    k, v = parallel.copy_in(k, mesh), parallel.copy_in(v, mesh)
    g = n_heads // k.shape[1]
    first = parallel.coord("model", mesh) * h_loc
    if h_loc % g == 0:
        return k[:, first // g:(first + h_loc) // g], v[:, first // g:(first + h_loc) // g]
    idx = torch.div(torch.arange(first, first + h_loc, device=k.device), g,
                    rounding_mode="floor")
    return k.index_select(1, idx), v.index_select(1, idx)


def gqa_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, *, causal: bool = True,
                probe: Optional[sal.ProbeSpec] = None, kv_x: Optional[torch.Tensor] = None,
                q_block: int = 512, use_kernel: bool = False, compact: bool = False,
                mesh=None) -> Tuple[torch.Tensor, AttnAux]:
    """Full-sequence GQA (prefill, the encoder, cross-attention), with the
    probe saliency over the key positions.  kv_x: a separate K/V source
    (cross-attention), whose keys and queries take no rotary, as in the
    reference; self-attention, causal or not, is rotated.  compact:
    `blocked_attention`'s bf16 logits and probabilities.  mesh: the
    training mesh whose `model` blocks of heads the weights hold, where
    they are split (`parallel.is_split`)."""
    src = x if kv_x is None else kv_x
    l, lkv = x.shape[1], src.shape[1]
    split, kv_split = parallel.is_split(params["wq"]), parallel.is_split(params["wk"])
    dt = x.dtype
    if split:   # f32 entries: each head's product rounds once to dt, as the whole layer's
        x = parallel.enter(x, mesh)
        if kv_split:
            src = x if kv_x is None else parallel.enter(kv_x, mesh)
    q = common.einsum("ble,ehd->bhld", x, params["wq"]).to(dt)
    k = common.einsum("ble,ehd->bhld", src, params["wk"]).to(src.dtype if not kv_split else dt)
    v = common.einsum("ble,ehd->bhld", src, params["wv"]).to(k.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"][None, :, None, :]
        k = k + params["bk"][None, :, None, :]
        v = v + params["bv"][None, :, None, :]
    if causal or kv_x is None:
        cos_q, sin_q = common.rotary_cos_sin(torch.arange(l, device=x.device), cfg.hd,
                                             cfg.rope_theta)
        cos_k, sin_k = common.rotary_cos_sin(torch.arange(lkv, device=x.device), cfg.hd,
                                             cfg.rope_theta)
        q = common.apply_rotary(q, cos_q[None, None], sin_q[None, None])
        k = common.apply_rotary(k, cos_k[None, None], sin_k[None, None])
    if split and not kv_split:
        k, v = _local_kv(k, v, cfg.n_heads, q.shape[1], mesh)
    out, colsum = blocked_attention(q, k, v, causal=causal, q_block=q_block, probe=probe,
                                    use_kernel=use_kernel, compact=compact)
    if split:   # row-parallel: f32 partials summed over `model`, one rounding
        y = parallel.leave(common.out_proj(out.transpose(1, 2).float(), params["wo"]), dt, mesh)
    else:
        y = common.out_proj(out.transpose(1, 2), params["wo"])  # heads beside d
    saliency = nnz = None
    if probe is not None and colsum is not None:
        saliency, nnz = probe_saliency_from_colsum(colsum, probe, lkv, causal=causal)
    return y, AttnAux(k=k, v=v, saliency=saliency, probe_nnz=nnz)


def gqa_decode_qkv(params: dict, x_t: torch.Tensor, cfg: ArchConfig, position: torch.Tensor):
    """x_t: (b, e), position: (b,) -> q_t (b,h,d), k_t/v_t (b,hk,d)."""
    q, k, v = _qkv(params, x_t, "be,ehd->bhd")
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    cos, sin = common.rotary_cos_sin(position, cfg.hd, cfg.rope_theta)  # (b, d/2)
    q = common.apply_rotary(q, cos[:, None], sin[:, None])
    k = common.apply_rotary(k, cos[:, None], sin[:, None])
    return q, k, v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): materialized for prefill, absorbed for decode
# ---------------------------------------------------------------------------

def mla_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
                probe: Optional[sal.ProbeSpec] = None, q_block: int = 512,
                use_kernel: bool = False, compact: bool = False, mesh=None
                ) -> Tuple[torch.Tensor, AttnAux]:
    """Full-sequence MLA (mesh: as `gqa_forward`'s).  Returns the latent cache streams in AttnAux:
    aux.k = rope key (b, 1, l, p), aux.v = latent (b, 1, l, r).  The softmax
    scale 1/sqrt(nope + rope) is q's last dim; v's head dim is v_head_dim."""
    b, l, e = x.shape
    h, p = params["w_q_nope"].shape[1], cfg.rope_head_dim     # this rank's heads
    split = parallel.is_split(params["w_q_nope"])
    cos, sin = common.rotary_cos_sin(torch.arange(l, device=x.device), p, cfg.rope_theta)
    latent = common.rms_norm(common.einsum("ble,er->blr", x, params["w_dkv"]),
                             params["kv_norm"], cfg.norm_eps)
    k_pe = common.apply_rotary(common.einsum("ble,ep->blp", x, params["w_kpe"]), cos, sin)
    # the head-split products take f32 copies whose gradients sum over `model`
    dt = x.dtype
    xh, lat_h, k_pe_h = ((parallel.enter(t, mesh) for t in (x, latent, k_pe)) if split
                         else (x, latent, k_pe))
    q_nope = common.einsum("ble,ehd->bhld", xh, params["w_q_nope"]).to(dt)
    q_pe = common.apply_rotary(common.einsum("ble,ehp->bhlp", xh, params["w_q_pe"]).to(dt),
                               cos[None, None], sin[None, None])
    k_nope = common.einsum("blr,rhd->bhld", lat_h, params["w_uk"]).to(dt)
    val = common.einsum("blr,rhv->bhlv", lat_h, params["w_uv"]).to(dt)
    q_full = torch.cat([q_nope, q_pe], dim=-1)                      # (b, h, l, nd + p)
    k_full = torch.cat([k_nope, k_pe_h.to(dt)[:, None].expand(b, h, l, p)], dim=-1)
    out, colsum = blocked_attention(q_full, k_full, val, causal=True, q_block=q_block,
                                    probe=probe, use_kernel=use_kernel, compact=compact)
    if split:
        y = parallel.leave(common.out_proj(out.transpose(1, 2).float(), params["wo"]), dt, mesh)
    else:
        y = common.out_proj(out.transpose(1, 2), params["wo"])
    saliency = nnz = None
    if probe is not None and colsum is not None:
        saliency, nnz = probe_saliency_from_colsum(colsum, probe, l)
    return y, AttnAux(k=k_pe[:, None], v=latent[:, None], saliency=saliency, probe_nnz=nnz)


def mla_kv_t(params: dict, x_t: torch.Tensor, cfg: ArchConfig, position: torch.Tensor):
    """One token's cache entries: (rope key (b, p), latent (b, r))."""
    cos, sin = common.rotary_cos_sin(position, cfg.rope_head_dim, cfg.rope_theta)
    latent_t = common.rms_norm(common.einsum("be,er->br", x_t, params["w_dkv"]),
                               params["kv_norm"], cfg.norm_eps)
    k_pe_t = common.apply_rotary(common.einsum("be,ep->bp", x_t, params["w_kpe"]), cos, sin)
    return k_pe_t, latent_t


def mla_decode(params: dict, x_t: torch.Tensor, cache, cfg: ArchConfig,
               position: torch.Tensor, impl: str = "ref"):
    """Absorbed-matmul MLA decode (one token) against the latent cache, a
    `MixedKVCache` holding k = rope key (b, 1, S, p), v = latent (b, 1, S, r).
    impl: "ref" (exact, dequantized streams) or "int8_algebra".
    Returns (y_t (b, e), slot_weights (b, S)): the reference's first and last
    outputs (its middle two are `mla_kv_t`'s)."""
    from repro_torch.core import kvcache as kvc

    p, nd = cfg.rope_head_dim, cfg.nope_head_dim
    cos, sin = common.rotary_cos_sin(position, p, cfg.rope_theta)
    q_nope = common.einsum("be,ehd->bhd", x_t, params["w_q_nope"])
    q_pe = common.apply_rotary(common.einsum("be,ehp->bhp", x_t, params["w_q_pe"]),
                               cos[:, None], sin[:, None])
    q_abs = common.einsum("bhd,rhd->bhr", q_nope, params["w_uk"])   # absorb W_uk
    scale = 1.0 / ((nd + p) ** 0.5)
    if impl == "int8_algebra":
        out_latent, slot_w = kvc.attend_decode_mla_int8(q_abs, q_pe, cache, scale)
    elif impl == "ref":
        k_pe_all, latent_all, valid, _ = kvc.cache_keys_values(cache)
        k_pe_all, latent_all = k_pe_all[:, 0].float(), latent_all[:, 0].float()
        logits = (torch.einsum("bhr,bsr->bhs", q_abs.float(), latent_all)
                  + torch.einsum("bhp,bsp->bhs", q_pe.float(), k_pe_all)) * scale
        w = torch.softmax(logits.masked_fill(~valid[:, None, :], NEG_INF), dim=-1)
        out_latent = torch.einsum("bhs,bsr->bhr", w, latent_all)
        slot_w = w.mean(dim=1)
    else:
        raise ValueError(f"unknown decode impl {impl!r}; one of ('ref', 'int8_algebra')")
    out = common.einsum("bhr,rhv->bhv", out_latent.to(x_t.dtype), params["w_uv"])
    y = common.out_proj(out, params["wo"])
    return y, slot_w
