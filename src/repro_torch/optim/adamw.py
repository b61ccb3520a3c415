"""AdamW with f32 master weights (port of `repro.optim.adamw`).

The state mirrors the parameter tree: an f32 master copy, m and v, and an
int32 step count.  `adamw_update` updates in place, as the reference's CLI
jits its step with donated buffers: the new master, m and v go into the
state's tensors and each new parameter into its own leaf, so a step holds
one training state, not two.  The arithmetic is the reference's f32 one,
per leaf: the clip factor from the global norm, the bias corrections
`1 - b ** count`, and the bf16 parameters rounded from the new master.
Divisions by a Python number are true divisions and the square root is
correctly rounded (`core.quant`), as the reference computes them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.quant import correctly_rounded_sqrt


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class AdamWState(NamedTuple):
    master: Any   # f32 params
    m: Any
    v: Any
    count: torch.Tensor


def adamw_init(params) -> AdamWState:
    leaves = tree_lib.leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return AdamWState(
        tree_lib.tree_map(lambda x: x.to(torch.float32, copy=True), params),
        tree_lib.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                          params),
        tree_lib.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                          params),
        torch.zeros((), dtype=torch.int32, device=device))


def global_norm(grads) -> torch.Tensor:
    return correctly_rounded_sqrt(sum(torch.sum(torch.square(g.float()))
                                      for g in tree_lib.leaves(grads)))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


_CHUNK = 1 << 24   # elements of a leaf updated at once


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params,
                 param_dtype=torch.bfloat16, *, norm_fn: Callable = None,
                 put: Optional[Callable] = None
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new params in `param_dtype`, new state, metrics); both trees
    are the given ones, updated in place.

    `params` and `state` are given up to the update.  A parameter leaf of
    another dtype (the f32 router of a fresh MoE tree) is made anew in
    `param_dtype`.  Each leaf updates in flat chunks of `_CHUNK` elements:
    the update is elementwise, so the chunks change no bit, and its ~20 f32
    temporaries of a chunk stay near 1.3 GB whatever the leaf's shape (a
    whole stacked leaf, mamba2's w_x at 64 x 2560 x 5120, would take ~25 GB).
    Master, m and v must be contiguous, as `adamw_init` and a restore make
    them.

    On a mesh (`launch.steps`) the grads, master, m and v are this rank's
    ZeRO-1 blocks and the params its parameter blocks: `norm_fn(grads)`
    gives the global norm over every rank's blocks, and `put(i, p, p32,
    param_dtype)` makes leaf i's new parameter block from its new master
    block."""
    count = state.count + 1
    gnorm = (norm_fn or global_norm)(grads)
    clip = (torch.clamp_max(_scalar(cfg.grad_clip, gnorm) / gnorm.clamp_min(1e-9), 1.0)
            if cfg.grad_clip else 1.0)
    lr = _scalar(cfg.lr, gnorm)
    if cfg.schedule is not None:
        lr = lr * cfg.schedule(count)
    cf = count.float()
    b1c = 1.0 - torch.pow(_scalar(cfg.b1, cf), cf)
    b2c = 1.0 - torch.pow(_scalar(cfg.b2, cf), cf)

    def upd(g, p32, m, v):
        g = g.float() * clip
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        step = mh / (correctly_rounded_sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        return p32 - lr * step, m, v

    out = []
    for i, (p, g, p32, m, v) in enumerate(zip(*(tree_lib.leaves(t) for t in (
            params, grads, state.master, state.m, state.v)))):
        chunks = zip(*(t.view(-1).split(_CHUNK) for t in (p32, m, v)),
                     g.reshape(-1).split(_CHUNK))
        for p32_c, m_c, v_c, g_c in chunks:
            for old, new in zip((p32_c, m_c, v_c), upd(g_c, p32_c, m_c, v_c)):
                old.copy_(new)
        if put is not None:
            out.append(put(i, p, p32, param_dtype))
        else:
            out.append(p.copy_(p32) if p.dtype == param_dtype else p32.to(param_dtype))
    return (tree_lib.unflatten(params, out), AdamWState(state.master, state.m, state.v, count),
            {"grad_norm": gnorm, "lr": lr})
