"""FFN mixers: dense SwiGLU and fine-grained MoE (port of `repro.models.mlp`,
the MoE without a mesh: every expert local, no expert parallelism).

MoE dispatch is the reference's capacity slotting: each token's top-k
(expert, gate) pairs are sorted by expert (stable, so within an expert the
earlier token comes first), each expert keeps its first `capacity` pairs
and drops the rest, and the kept tokens run through their experts as one
batched product per weight over (experts, capacity) slots.  The capacity
is a Python int from static shapes (`ceil(b*s*k/E * capacity_factor)`),
and every step of the dispatch is a device op (sort, searchsorted,
gathers): nothing syncs with the host, so a decode step holding it can be
captured.

Continuous batching: `active` (b,) marks the live rows of a decode batch;
the pairs of the other rows sort after every expert's and take no slot (the
reference's `valid` key, which its expert-parallel dispatch gives the pairs
of other shards' experts), so an empty or retired slot's garbage token
never drops a live token's pair.  The reference's ContinuousEngine refuses
MoE archs for want of exactly this; on every path it does run (no `active`)
the dispatch is its own.  Prompt padding still takes slots, as in the
reference.

The combine adds each token's k contributions in the reference's order and
rounding: its contributions in expert order (the sorted order of the
reference's `.at[token_of].add`), each addition rounded to h's dtype.  It
is a gather and k elementwise adds, with no atomics: bitwise reproducible,
on the card as on the CPU.

Under autograd both gathers (the tokens into their slots, the slots back
to their pairs) take `common.gather_rows`: a row's gradient sums its
contributions in f32 and rounds once, with no atomics, so two identical
steps are bitwise on the card.  The reference's scatter-add sums a
token's k contributions in bf16, so `x`'s gradient, and everything
upstream of it, is a rounding apart from the reference's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models.common import ParamDef


def dense_mlp_schema(cfg: ArchConfig, d_ff: Optional[int] = None) -> dict:
    e, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_gate": ParamDef((e, f)), "w_up": ParamDef((e, f)), "w_down": ParamDef((f, e))}


def dense_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    return common.swiglu(x, params["w_gate"], params["w_up"], params["w_down"])


def moe_schema(cfg: ArchConfig) -> dict:
    e, f, n = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    s = {
        "router": ParamDef((e, n), init="small", dtype=torch.float32),
        "w_gate": ParamDef((n, e, f)),
        "w_up": ParamDef((n, e, f)),
        "w_down": ParamDef((n, f, e)),
    }
    if cfg.n_shared_experts:
        s["shared"] = dense_mlp_schema(cfg, cfg.n_shared_experts * cfg.moe_d_ff)
    return s


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for n_tokens tokens (the reference's rule, mesh=None)."""
    return max(1, int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def _expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """buf (E, C, e) -> (E, C, e), per-expert SwiGLU."""
    g = common.einsum("xce,xef->xcf", buf, w_gate)
    u = common.einsum("xce,xef->xcf", buf, w_up)
    h = F.silu(g.float()).to(buf.dtype) * u
    return common.einsum("xcf,xfe->xce", h, w_down)


def _dispatch_compute(x_flat: torch.Tensor, gates: torch.Tensor, eidx: torch.Tensor,
                      w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                      capacity: int, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Capacity-slotted dispatch of N tokens over all E experts -> (N, e).

    x_flat (N, e); gates (N, k) f32 combine weights; eidx (N, k) int expert
    ids (distinct within a row); valid: optional (N,) bool, the tokens that
    take slots.  Pair i = token i // k's j-th choice; the pairs sorted by
    expert (stable, invalid pairs last) fill each expert's slots in order,
    and a pair past its expert's capacity, or invalid, is dropped (adds 0)."""
    n, k = eidx.shape
    n_exp = w_gate.shape[0]
    dev = x_flat.device
    flat_e = eidx.reshape(-1).long()
    if valid is not None:
        flat_e = torch.where(valid[:, None].expand(n, k).reshape(-1), flat_e, n_exp)
    sort_idx = torch.sort(flat_e, stable=True).indices            # pairs in expert order
    sorted_e = flat_e[sort_idx]
    experts = torch.arange(n_exp + 1, device=dev)                  # E: the invalid pairs
    first = torch.searchsorted(sorted_e, experts, side="left")     # (E + 1,)
    starts = first[:n_exp]
    counts = torch.searchsorted(sorted_e, experts[:n_exp], side="right") - starts
    # slot (x, c) holds the pair at sorted position starts[x] + c, if x has one
    slot_c = torch.arange(capacity, device=dev)
    filled = slot_c[None, :] < counts[:, None]                     # (E, C)
    src = (starts[:, None] + slot_c[None, :]).clamp_max(n * k - 1)
    token_of = sort_idx // k
    rows = common.gather_rows(x_flat, token_of[src])               # (E, C, e)
    buf = torch.where(filled[..., None], rows, torch.zeros((), dtype=x_flat.dtype, device=dev))
    h = _expert_ffn(buf, w_gate, w_up, w_down).reshape(n_exp * capacity, -1)

    # each pair's slot: its rank within its expert, or dropped
    rank_sorted = torch.arange(n * k, device=dev) - first[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, sort_idx, rank_sorted).reshape(n, k)
    keep = (rank < capacity) & (flat_e.reshape(n, k) < n_exp)
    dest = (eidx.long() * capacity + rank.clamp_max(capacity - 1))
    contrib = common.gather_rows(h, dest) * gates.to(h.dtype)[..., None]   # (N, k, e)
    contrib = torch.where(keep[..., None], contrib, torch.zeros((), dtype=h.dtype, device=dev))
    # a token's pairs meet in expert order in the sorted list: add them so
    order = torch.sort(eidx.long(), dim=1).indices
    contrib = torch.gather(contrib, 1, order[..., None].expand_as(contrib))
    out = torch.zeros_like(x_flat)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def route(params: dict, x: torch.Tensor, cfg: ArchConfig):
    """The f32 router over x (b, s, e) -> (probs (b, s, E), gates (b, s, k)
    renormalized over the top k, expert ids (b, s, k))."""
    k = cfg.top_k
    # the router is f32 until a training step: AdamW, as the reference's,
    # hands back every parameter in bf16; the product promotes it
    logits = torch.einsum("bse,en->bsn", x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k's order: descending, the lower expert first on ties
    gate_vals, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, eidx = gate_vals[..., :k], eidx[..., :k]
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9), eidx


def _aux_loss(probs: torch.Tensor, eidx: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Switch-style load balancing from the router's probabilities and
    top-k ids: E * sum_e f_e * P_e, times `router_aux_coef`."""
    me = probs.mean(dim=(0, 1))
    ce = torch.zeros_like(probs).scatter_(-1, eidx, 1.0).mean(dim=(0, 1))
    return cfg.n_experts * (me * ce).sum() * cfg.router_aux_coef


def moe_ffn(params: dict, x: torch.Tensor, cfg: ArchConfig,
            active: Optional[torch.Tensor] = None, with_aux: bool = False):
    """Fine-grained MoE FFN. x: (b, s, e) (s may be 1 for decode); active:
    optional (b,) bool, the rows whose tokens take expert slots.  Returns
    the reference's `MoEOut.y`, or with `with_aux` the pair (y, aux loss)."""
    b, s, e = x.shape
    k = cfg.top_k
    probs, gate_vals, eidx = route(params, x, cfg)
    y = _dispatch_compute(x.reshape(b * s, e), gate_vals.reshape(b * s, k),
                          eidx.reshape(b * s, k), params["w_gate"], params["w_up"],
                          params["w_down"], capacity(cfg, b * s),
                          None if active is None else active[:, None].expand(b, s).reshape(-1)
                          ).reshape(b, s, e)
    if cfg.n_shared_experts:
        y = y + dense_mlp(params["shared"], x)
    return (y, _aux_loss(probs, eidx, cfg)) if with_aux else y
