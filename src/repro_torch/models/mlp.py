"""FFN mixers: dense SwiGLU and fine-grained MoE (port of `repro.models.mlp`).

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

On a mesh (`models.parallel`), the reference's `shard_map` semantics: each
rank routes its own rows' tokens, the capacity comes from that local token
count, model rank r holds experts [r * E / ep, (r + 1) * E / ep) and
dispatches only the pairs that chose them (the others sort last and add
nothing), and the ranks' partial outputs are summed over `model` in the
activations' dtype.  The aux loss's statistics are means over the global
batch (summed over the data axes).  The dense MLP's width splits over
`model` Megatron style (`w_gate` / `w_up` column-parallel, `w_down`
row-parallel).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quant import true_div
from repro_torch.models import common, parallel
from repro_torch.models.common import ParamDef


def dense_mlp_schema(cfg: ArchConfig, d_ff: Optional[int] = None) -> dict:
    e, f = cfg.d_model, d_ff or cfg.d_ff
    return common.computed_split(      # the width over `model` on a mesh
        {"w_gate": ParamDef((e, f), ("embed", "mlp")), "w_up": ParamDef((e, f), ("embed", "mlp")),
         "w_down": ParamDef((f, e), ("mlp", "embed"))})


def dense_mlp(params: dict, x: torch.Tensor, mesh=None) -> torch.Tensor:
    if not parallel.is_split(params["w_gate"]):
        return common.swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
    # this rank's block of the width: f32 entry, each product rounded once
    # to x's dtype as the whole MLP's, the f32 partial outputs summed
    xf = parallel.enter(x, mesh)
    g = common.einsum("...e,ef->...f", xf, params["w_gate"]).to(x.dtype)
    u = common.einsum("...e,ef->...f", xf, params["w_up"]).to(x.dtype)
    h = F.silu(g.float()).to(x.dtype) * u
    return parallel.leave(common.einsum("...f,fe->...e", h.float(), params["w_down"]), x.dtype,
                          mesh)


def moe_schema(cfg: ArchConfig) -> dict:
    e, f, n = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    s = {
        "router": ParamDef((e, n), ("embed", "experts"), init="small", dtype=torch.float32),
        # the experts over `model` on a mesh (the router is gathered whole)
        "w_gate": ParamDef((n, e, f), ("experts", "expert_in", "moe_mlp"), split=True),
        "w_up": ParamDef((n, e, f), ("experts", "expert_in", "moe_mlp"), split=True),
        "w_down": ParamDef((n, f, e), ("experts", "moe_mlp", "expert_in"), split=True),
    }
    if cfg.n_shared_experts:
        s["shared"] = dense_mlp_schema(cfg, cfg.n_shared_experts * cfg.moe_d_ff)
    return s


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for n_tokens tokens: the reference's rule, over the
    whole batch without a mesh and over a rank's own tokens on one."""
    return max(1, int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def _expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """buf (E, C, e) -> (E, C, e), per-expert SwiGLU."""
    g = common.einsum("xce,xef->xcf", buf, w_gate)
    u = common.einsum("xce,xef->xcf", buf, w_up)
    h = F.silu(g.float()).to(buf.dtype) * u
    return common.einsum("xcf,xfe->xce", h, w_down)


def _dispatch_compute(x_flat: torch.Tensor, gates: torch.Tensor, eidx: torch.Tensor,
                      w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                      capacity: int, valid: Optional[torch.Tensor] = None,
                      e_offset: Optional[int] = None) -> torch.Tensor:
    """Capacity-slotted dispatch of N tokens over E local experts -> (N, e).

    x_flat (N, e); gates (N, k) f32 combine weights; eidx (N, k) int expert
    ids (distinct within a row); valid: optional (N,) bool, the tokens that
    take slots; e_offset: on a mesh, the global id of the first local
    expert (the weights hold experts [e_offset, e_offset + E)).  Pair i = token i //
    k's j-th choice; the pairs sorted by local expert (stable; invalid
    pairs and pairs of other experts last) fill each expert's slots in
    order, and a pair past its expert's capacity, invalid or another's, is
    dropped (adds 0): the output is the local experts' part."""
    n, k = eidx.shape
    n_exp = w_gate.shape[0]
    dev = x_flat.device
    flat_e = eidx.reshape(-1).long()
    if e_offset is not None:
        flat_e = flat_e - e_offset
        flat_e = torch.where((flat_e >= 0) & (flat_e < n_exp), flat_e, n_exp)
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
    dest = (flat_e.reshape(n, k).clamp_max(n_exp - 1) * capacity
            + rank.clamp_max(capacity - 1))
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


def _aux_loss(probs: torch.Tensor, eidx: torch.Tensor, cfg: ArchConfig, mesh=None,
              data_axes=("data",)) -> torch.Tensor:
    """Switch-style load balancing from the router's probabilities and
    top-k ids: E * sum_e f_e * P_e, times `router_aux_coef`."""
    chosen = torch.zeros_like(probs).scatter_(-1, eidx, 1.0)
    dp = parallel.data_size(mesh, data_axes)
    if dp == 1:
        me = probs.mean(dim=(0, 1))
        ce = chosen.mean(dim=(0, 1))
    else:       # means over the global batch: this rank's sums, summed over the data axes
        n = probs.shape[0] * probs.shape[1] * dp
        me = true_div(parallel.sum_over_data(probs.sum(dim=(0, 1)), mesh, data_axes), n)
        ce = true_div(parallel.sum_over_data(chosen.sum(dim=(0, 1)), mesh, data_axes), n)
    return cfg.n_experts * (me * ce).sum() * cfg.router_aux_coef


def moe_ffn(params: dict, x: torch.Tensor, cfg: ArchConfig,
            active: Optional[torch.Tensor] = None, with_aux: bool = False, mesh=None,
            data_axes=("data",)):
    """Fine-grained MoE FFN. x: (b, s, e) (s may be 1 for decode); active:
    optional (b,) bool, the rows whose tokens take expert slots.  Returns
    the reference's `MoEOut.y`, or with `with_aux` the pair (y, aux loss).
    mesh, data_axes: the training mesh, x this rank's rows (the mesh
    semantics above)."""
    b, s, e = x.shape
    k = cfg.top_k
    probs, gate_vals, eidx = route(params, x, cfg)
    x_flat, gates = x.reshape(b * s, e), gate_vals.reshape(b * s, k)
    e_offset = None
    if mesh is not None:
        ep = parallel.size("model", mesh)
        assert cfg.n_experts % ep == 0, f"experts {cfg.n_experts} not divisible by EP {ep}"
        e_offset = parallel.coord("model", mesh) * (cfg.n_experts // ep)
        if parallel.is_split(params["w_gate"]):
            x_flat, gates = parallel.copy_in(x_flat, mesh), parallel.copy_in(gates, mesh)
    y = _dispatch_compute(x_flat, gates, eidx.reshape(b * s, k), params["w_gate"],
                          params["w_up"], params["w_down"], capacity(cfg, b * s),
                          None if active is None else active[:, None].expand(b, s).reshape(-1),
                          e_offset=e_offset)
    if parallel.is_split(params["w_gate"]):
        y = parallel.reduce_out(y, mesh)
    y = y.reshape(b, s, e)
    if cfg.n_shared_experts:
        y = y + dense_mlp(params["shared"], x, mesh)
    return (y, _aux_loss(probs, eidx, cfg, mesh, data_axes)) if with_aux else y
