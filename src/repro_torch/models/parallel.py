"""The collectives of training on a mesh: what GSPMD inserts into the
reference's programs, written out for `torch.distributed`.

The mesh step (`launch.steps.make_train_step(..., mesh=)`) hands the model
each parameter as this rank's block of its spec (`launch.sharding`), tagged
with a `LeafPlan`, and the mesh in its `RunCtx` (`ctx.mesh`, `ctx.data_axes`).
The model code passes that mesh to:

  * `gather_tree(params, mesh)` where a layer (or the top of the model) takes
    its weights: each leaf is all-gathered over `data` (FSDP; the backward
    reduce-scatters its gradient, summed in f32) and, unless the model
    computes it split, over `model` (the backward keeps this rank's block
    of a gradient every model rank computed alike).  Inside a recomputed
    layer the gather runs again in the backward pass;
  * `copy_in` / `reduce_out`, the two Megatron operators around a compute
    split over `model` (attention heads, the MLP width, the vocabulary,
    the experts): identity forward with a summed backward, and a summed
    forward with an identity backward.  `enter` / `leave` are the same in
    f32: a split product then rounds once, as the whole product does, where
    bf16 partial sums would round twice (the experts keep the reference's
    bf16 sum);
  * `sum_over_data` for the global statistics (the loss's token count, the
    MoE aux statistics).

Which leaves compute split is the schema's word (`ParamDef.split`, read
into `LeafPlan.keep_model`); a gathered leaf that keeps its `model` block
says so to the layer that takes it (`is_split`).  Without a mesh (None),
or on an axis of size 1, every one of them is the identity and adds no
op, so a 1 x 1 mesh computes the plain step's bits.  Collectives go over each mesh axis's process group (NCCL on the card, gloo
on the CPU); the reduce-scatter is an all-reduce and a slice on both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

ReduceOp = dist.ReduceOp


def size(axis: str, mesh) -> int:
    return 1 if mesh is None else mesh.shape.get(axis, 1)


def coord(axis: str, mesh) -> int:
    return 0 if mesh is None or axis not in mesh.shape else mesh.coord(axis)


def data_size(mesh, data_axes) -> int:
    """The ranks a batch's rows split over: the product of the data axes."""
    n = 1
    for a in data_axes:
        n *= size(a, mesh)
    return n


# ---------------------------------------------------------------------------
# Plain collectives (no autograd)
# ---------------------------------------------------------------------------

def all_gather_dim(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim)


def all_reduce(x: torch.Tensor, mesh, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of x over the axis's group, as a new tensor."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=op, group=mesh.group(axis))
    return y


def reduce_scatter_dim(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """This rank's block (along dim) of the sum of x over the axis, summed
    in f32 and rounded once to x's dtype: an all-reduce and a slice, on
    both backends (gloo has no reduce-scatter)."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    return all_reduce(x.float(), mesh, axis).chunk(n, dim)[mesh.coord(axis)].to(x.dtype)


def block(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    n = mesh.shape.get(axis, 1)
    return x if n == 1 else x.chunk(n, dim)[mesh.coord(axis)]


# ---------------------------------------------------------------------------
# The Megatron operators and the sums
# ---------------------------------------------------------------------------

class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_in(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Enter a compute split over `axis`: identity forward, the gradient
    summed over the axis."""
    if size(axis, mesh) == 1:
        return x
    return _CopyIn.apply(x, mesh, axis)


def reduce_out(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Leave a compute split over `axis`: the partial results summed (in
    x's dtype), the gradient passed through."""
    if size(axis, mesh) == 1:
        return x
    return _ReduceOut.apply(x, mesh, axis)


def enter(x: torch.Tensor, mesh) -> torch.Tensor:
    """An f32 copy of x entering a compute split over `model`: its products
    take f32 operands and round once to x's dtype, as the whole product
    would, and its gradient sums the ranks' f32 parts before x's backward
    rounds it once."""
    return copy_in(x.float(), mesh)


def leave(y: torch.Tensor, dtype, mesh) -> torch.Tensor:
    """The f32 partial products of a row-parallel weight summed over
    `model` in f32, then rounded once to `dtype`."""
    return reduce_out(y, mesh).to(dtype)


def sum_over_data(x: torch.Tensor, mesh, data_axes) -> torch.Tensor:
    """x summed over the data axes (the innermost first); the gradient
    passes through, so each rank's share of a global statistic takes its
    own."""
    for axis in reversed(tuple(data_axes)):
        x = reduce_out(x, mesh, axis)
    return x


# ---------------------------------------------------------------------------
# Parameters: the plan of a leaf and its gather on use
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one parameter leaf lives on the mesh.  pspec: the bf16
    parameter's spec; zspec: the optimizer state's (ZeRO-1); keep_model:
    the model computes the leaf's `model` block on its own (heads, MLP
    width, vocabulary, experts) instead of gathering it (the schema's
    `ParamDef.split`); keep_decode: so does the serving decode step, where
    the prefill gathers the leaf (`launch.sharding.serve_plans`)."""
    pspec: tuple
    zspec: tuple
    keep_model: bool
    keep_decode: bool = False

    def dim_of(self, spec, axis) -> Optional[int]:
        return spec.index(axis) if axis in spec else None

    def drop_leading(self) -> "LeafPlan":
        return LeafPlan(self.pspec[1:], self.zspec[1:], self.keep_model, self.keep_decode)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, ddim, mdim):
        ctx.mesh, ctx.ddim, ctx.mdim = mesh, ddim, mdim
        if ddim is not None:
            x = all_gather_dim(x, ddim, mesh, "data")
        if mdim is not None:
            x = all_gather_dim(x, mdim, mesh, "model")
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.mdim is not None:
            g = block(g, ctx.mdim, ctx.mesh, "model")
        if ctx.ddim is not None:
            g = reduce_scatter_dim(g, ctx.ddim, ctx.mesh, "data")
        return g, None, None, None


def gather(t: torch.Tensor, mesh, decode: bool = False) -> torch.Tensor:
    """A parameter leaf as the model computes with it: gathered over `data`
    and (unless kept) `model`; marked split where a `model` block stays.
    decode: the serving decode step's use (`LeafPlan.keep_decode` keeps)."""
    plan = getattr(t, "_plan", None)
    if plan is None or mesh is None:
        return t
    ddim = plan.dim_of(plan.pspec, "data") if size("data", mesh) > 1 else None
    mdim = plan.dim_of(plan.pspec, "model") if size("model", mesh) > 1 else None
    keep = (plan.keep_model or (decode and plan.keep_decode)) and mdim is not None
    if keep:
        mdim = None
    out = _Gather.apply(t, mesh, ddim, mdim) if (ddim is not None or mdim is not None) else t
    if keep:
        out = out.view_as(out)
        out._model_split = True
    return out


def gather_tree(tree, mesh, decode: bool = False):
    """Every leaf of a parameter tree gathered (`gather`); the tree itself
    without a mesh."""
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_tree(v, mesh, decode) for k, v in tree.items()}
    return gather(tree, mesh, decode)


def is_split(t: torch.Tensor) -> bool:
    """Whether a gathered weight is this rank's `model` block of a split
    compute."""
    return getattr(t, "_model_split", False)


def unbind(t: torch.Tensor):
    """`t.unbind(0)` that hands each layer's view the leaf's plan."""
    parts = t.unbind(0)
    plan = getattr(t, "_plan", None)
    if plan is not None:
        sub = plan.drop_leading()
        for p in parts:
            p._plan = sub
    return parts
