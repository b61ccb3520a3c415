"""int8 gradient compression with error feedback (port of
`repro.optim.grad_compress`), for the slowest hop of data parallelism (the
`pod` axis).

Each leaf is quantized with one max-abs scale to int8 codes; the residual
(what the codes missed) is carried into the next step (EF-SGD style).
`compressed_psum_leaf` is the mean over a mesh axis of the ranks'
dequantized codes: an all-reduce over the axis's process group, divided by
its size.  As in the reference, no launcher calls it.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.quant import true_div
from repro_torch.models import parallel


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = true_div(torch.clamp_min(x.abs().max(), 1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_leaf(g: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """The int8-compressed mean of g over an axis of `mesh`: each rank's
    dequantized codes, summed over the axis's group in f32, divided by its
    size."""
    q, scale = quantize_int8(g.float())
    part = q.float() * scale
    n = mesh.shape[axis]
    return true_div(parallel.all_reduce(part, mesh, axis), n)


def ef_compress_step(grads: Any, residual: Any, axis, mesh=None) -> Tuple[Any, Any]:
    """Error-feedback compression: (synced grads, new residual); axis None
    syncs nothing (the dequantized codes themselves), else the mean over
    that axis of `mesh`."""
    def leaf(g, r):
        x = g.float() + r
        q, scale = quantize_int8(x)
        approx = dequantize_int8(q, scale)
        new_r = x - approx
        synced = compressed_psum_leaf(approx, axis, mesh) if axis else approx
        return synced, new_r

    pairs = [leaf(g, r) for g, r in zip(tree_lib.leaves(grads), tree_lib.leaves(residual))]
    return (tree_lib.unflatten(grads, [p[0] for p in pairs]),
            tree_lib.unflatten(grads, [p[1] for p in pairs]))


def init_residual(params: Any) -> Any:
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
