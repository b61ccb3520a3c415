"""Shared model machinery (port of `repro.models.common`): parameter schema
and seeded init, norms, rotary embeddings, SwiGLU, embedding lookup, the
next-token cross entropy."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.core.quant import true_div
from repro_torch.models import parallel


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """A parameter leaf: its shape, the logical axis name of each dim (the
    names `launch.sharding`'s rules map onto mesh axes), its init and dtype.
    split: on a mesh the layer that takes the leaf computes with this
    rank's block of its `model` dim (heads, MLP width, vocabulary, experts)
    where the rules split one; otherwise the leaf is gathered whole
    (`models.parallel`)."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | embed | small
    scale: float = 1.0
    dtype: torch.dtype = torch.bfloat16
    split: bool = False

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def computed_split(schema, split: bool = True):
    """The schema with every leaf's `split` set (a layer that computes its
    `model` blocks on its own), or cleared."""
    if isinstance(schema, ParamDef):
        return dataclasses.replace(schema, split=split)
    return {k: computed_split(v, split) for k, v in schema.items()}


def stack_schema(schema, n: int, axis_name: str = "layers"):
    """Add a leading stacked (layer) dimension, named `axis_name`, to every leaf."""
    if isinstance(schema, ParamDef):
        return dataclasses.replace(schema, shape=(n, *schema.shape),
                                   axes=(axis_name, *schema.axes))
    return {k: stack_schema(v, n, axis_name) for k, v in schema.items()}


_CHUNK = 1 << 26  # elements drawn per f32 chunk, to bound the init's transient memory


def _trunc_normal_(out: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Fill `out` with a standard normal truncated to [-2, 2], times std, by
    inverting the CDF of a uniform draw (row chunks along axis 0)."""
    lo, hi = (0.5 * (1.0 + math.erf(t / math.sqrt(2.0))) for t in (-2.0, 2.0))
    flat = out.view(out.shape[0], -1) if out.dim() > 1 else out.view(1, -1)
    rows = max(1, _CHUNK // max(flat.shape[1], 1))
    for r in range(0, flat.shape[0], rows):
        u = torch.rand(flat[r:r + rows].shape, generator=gen, device=out.device)
        x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
        flat[r:r + rows] = (x.clamp_(-2.0, 2.0) * std).to(out.dtype)


def _init_leaf(p: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    # the reference's rule: fan-in is the leaf's leading axis (for stacked
    # layer weights that is the layer count), std = 1/sqrt(fan_in)
    # ("small": std 0.02, the MoE router's f32 init)
    if p.init == "embed":
        std = 1.0
    elif p.init == "small":
        std = 0.02
    else:
        std = 1.0 / math.sqrt(max(p.shape[0] if p.shape else 1, 1))
    out = torch.empty(p.shape, dtype=p.dtype, device=device)
    _trunc_normal_(out, std * p.scale, gen)
    return out


def materialize(schema, seed: int = 0, device="cuda"):
    """Seeded parameters at the schema's shapes and dtypes (a torch.Generator
    on `device`; the values differ from the JAX package's draws)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def walk(node):
        if isinstance(node, ParamDef):
            return _init_leaf(node, gen, device)
        return {k: walk(node[k]) for k in sorted(node)}

    return walk(schema)


# each layer weight's contracted axes, after its leading layer (and expert) axes
_FAN_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1, "w_down": 1,
             "w_dkv": 1, "w_kpe": 1, "w_q_nope": 1, "w_q_pe": 1, "w_uk": 1, "w_uv": 1,
             "w_z": 1, "w_x": 1, "w_B": 1, "w_C": 1, "w_dt": 1, "out_proj": 1}
_STACKED = ("groups", "enc_layers", "dec_layers")   # trees with a leading layer axis


def fan_in_init(params):
    """The same draws at std 1 / sqrt(fan-in): each layer weight, drawn at
    the reference's 1 / sqrt(its leading axis) (for a stacked weight (L,
    ...) or an MoE expert weight (L, E, ...), the layer count), scaled by
    sqrt(leading axis / fan-in), the embedding (std 1) by 1 / sqrt(d_model);
    every other leaf as it is.  At the reference's init a wide model's bf16
    gradients are rounding noise; at this one they are not, so a card's
    gradients can be held to another device's."""

    def scale(name, t):
        path = name.split("/")
        key = path[-1]
        if key == "embed":
            return (t.float() / math.sqrt(t.shape[1])).to(t.dtype)
        if key in _FAN_AXES:
            lead = (path[0] in _STACKED) + (path[-2] == "moe")
            fan = math.prod(t.shape[lead:lead + _FAN_AXES[key]])
            return (t.float() * math.sqrt(t.shape[0] / fan)).to(t.dtype)
        return t

    return tree_lib.unflatten(params, [scale(n, t) for n, t in tree_lib.named_leaves(params)])


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

class _RowGather(torch.autograd.Function):
    """A row gather whose backward sums each row's gradient in f32, in the
    order of the indices, and rounds once, as the reference's one-hot
    matmul's does for the embedding: the CPU's bf16 embedding or index
    backward adds in bf16, ~4% off for a token that repeats a few hundred
    times.  On the card the f32 sum is the sort-based
    `embedding_dense_backward`: no atomics, bitwise reproducible."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return F.embedding(idx, table)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        g = torch.ops.aten.embedding_dense_backward(grad.float(), idx, ctx.n_rows, -1, False)
        return g.to(grad.dtype), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 2-D table and int indices of any shape; under
    autograd its gradient sums each row's contributions in f32 and rounds
    once (`_RowGather`): the embedding lookup and the MoE dispatch's token
    and slot gathers."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _RowGather.apply(table, idx.long())
    return F.embedding(idx.long(), table)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Row gather; equal to the reference's one-hot matmul bit for bit, its
    gradient too (`gather_rows`).  A table split over the mesh's `model`
    axis (`parallel.is_split`) holds a slice of the vocabulary: each rank
    looks up the tokens in its slice, zeros for the rest, and the ranks'
    rows are summed (one nonzero term each: exact)."""
    if not parallel.is_split(table):
        return gather_rows(table, tokens)
    off = parallel.coord("model", mesh) * table.shape[0]
    local = tokens.long() - off
    mine = (local >= 0) & (local < table.shape[0])
    rows = gather_rows(table, torch.where(mine, local, 0))
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return parallel.reduce_out(rows, mesh)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rotary_cos_sin(positions: torch.Tensor, dim: int, theta: float, dtype=torch.float32):
    """positions: (...,) int -> cos/sin (..., dim/2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, dim) with cos/sin (..., seq, dim/2) broadcastable."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their promoted dtype: the reference's products of
    f32 activations and bf16 weights (seamless's encoder, the cross
    attention's K/V) promote, and torch's products take one dtype."""
    if a.dtype == b.dtype:
        return a, b
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t), b.to(t)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product of two model tensors: f32 accumulation, one rounding to the
    operands' dtype, as XLA and cuBLAS compute a bf16 product.  The CPU's
    bf16 GEMM rounds differently, so on the CPU the operands go up to f32.
    Operands of two dtypes compute in the promoted one."""
    a, b = _promoted(a, b)
    if a.device.type == "cpu" and a.dtype == torch.bfloat16:
        return torch.einsum(eq, a.float(), b.float()).to(a.dtype)
    return torch.einsum(eq, a, b)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with `einsum`'s rounding (the CPU's bf16 operands go up to f32;
    two dtypes compute in the promoted one).  The model's weight-stationary
    products go through here with `b` a view of the weight (`w.reshape(h *
    d, e)`, `embed.T`): `torch.einsum` would permute such a weight and copy
    all of it before its GEMM."""
    a, b = _promoted(a, b)
    if a.device.type == "cpu" and a.dtype == torch.bfloat16:
        return (a.float() @ b.float()).to(a.dtype)
    return a @ b


def out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The attention-output projection: out (..., h, d) @ wo (h, d, e) ->
    (..., e), contracted over the flattened (h * d) axis through views."""
    h, d, e = wo.shape
    return matmul(out.reshape(*out.shape[:-2], h * d), wo.reshape(h * d, e))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = einsum("...e,ef->...f", x, w_gate)
    u = einsum("...e,ef->...f", x, w_up)
    return einsum("...f,fe->...e", F.silu(g.float()).to(x.dtype) * u, w_down)


def layer_slice(tree, i: int):
    """Layer i of a tree of stacked (leading layer axis) tensors; a leaf's
    mesh plan (`parallel.LeafPlan`) passes to its layer's view."""
    if isinstance(tree, torch.Tensor):
        plan = getattr(tree, "_plan", None)
        out = tree[i]
        if plan is not None:
            out._plan = plan.drop_leading()
        return out
    return {k: layer_slice(v, i) for k, v in tree.items()}


def _vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, offset: int, mesh):
    """The nll of f32 logits that hold vocabulary columns [offset, offset +
    width) of every model rank's slice: the max and the sum of exponentials
    reduced over `model`, the gold logit taken by the rank that holds it."""
    from repro_torch.models.parallel import ReduceOp
    m = parallel.all_reduce(logits.detach().amax(dim=-1), mesh, "model", op=ReduceOp.MAX)
    sumexp = parallel.reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1), mesh)
    local = labels.long() - offset
    mine = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    gold = parallel.reduce_out(torch.where(mine, gold, torch.zeros((), device=gold.device)),
                               mesh)
    return m + torch.log(sumexp) - gold


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       vocab_offset: Optional[int] = None, mesh=None,
                       data_axes=("data",)) -> torch.Tensor:
    """Mean next-token CE over the valid positions: the f32 logsumexp minus
    the gold logit.  logits (..., vocab) in any float dtype.

    On a mesh (`mesh`, its `data_axes`): `vocab_offset` marks logits that hold one
    model rank's slice of the vocabulary, starting there; and a rank that
    holds some of the batch's rows returns its share of the global mean,
    its rows' sum over the whole batch's count (summed over the data axes),
    so the ranks' shares add up to the loss."""
    logits = logits.float()
    if vocab_offset is None:
        nll = torch.logsumexp(logits, dim=-1) - torch.gather(
            logits, -1, labels.long()[..., None])[..., 0]
    else:
        nll = _vocab_parallel_nll(logits, labels, vocab_offset, mesh)
    dp = parallel.data_size(mesh, data_axes)
    if mask is not None:
        m = mask.float()
        count = m.sum() if dp == 1 else parallel.sum_over_data(m.sum().detach(), mesh,
                                                                data_axes)
        return (nll * m).sum() / count.clamp_min(1.0)
    return true_div(nll.sum(), nll.numel() * dp)
