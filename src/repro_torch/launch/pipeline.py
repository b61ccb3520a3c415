"""Pipeline parallelism, GPipe over a `stage` mesh axis (port of
`repro.launch.pipeline`).

The layer-group stack shards over `stage` (`PP_OVERRIDES`, {"layers":
"stage"}): each stage owns n_groups / S contiguous groups, and the
activations flow from stage to stage (`parallel.stage_shift`, the
reference's `ppermute`).  The GPipe schedule runs M microbatches through
S stages in M + S - 1 ticks: stage 0 injects microbatch t at tick t, and
stage s runs microbatch t - s.  A stage skips its bubble ticks, on which
it holds no microbatch (the reference computes on zeros there, results
that never reach an output).  The embedding and the unembedding stay
outside the pipelined region, replicated over `stage`.  Inside a stage
the layers run with the mesh, so the data and model splits of the mesh
step (`launch.steps`) apply there; the reference drops the mesh inside
its `shard_map` and lets GSPMD propagate the same splits.

Scope, as the reference's: homogeneous dense stacks (`supports_pp`):
yi-6b / 34b, qwen2-7b, smollm, llava's backbone.  A frontend arch's
pipeline embeds its text tokens alone (the reference ignores
`frontend_embeds` there).

Every function takes this rank's blocks: the parameters of
`pp_param_pspecs` (`steps.shard_train_state(params, cfg, mesh,
PP_OVERRIDES)`) and the rows of `steps.local_batch(batch, mesh,
microbatches)`.

    mesh = make_pp_mesh(stages=4, data=8, model=8)        # under torchrun
    step = make_pp_train_step(cfg, mesh, microbatches=8)
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import data_axes_of, make_pp_mesh  # noqa: F401  (the reference's name)
from repro_torch.models import blocks, common, lm, parallel, registry
from repro_torch.optim import adamw

PP_OVERRIDES = {"layers": "stage"}


def _unsupported(cfg: ArchConfig) -> Optional[str]:
    causes = [(cfg.encdec, "it is an encoder-decoder"),
              (cfg.n_experts, "its MoE layers route over their own mesh collectives"),
              (cfg.ssm, "it has SSM layers"),
              (cfg.attn_layer_period, "its stack is a hybrid of attention and SSM layers"),
              (cfg.first_dense_layers, "it has unstacked prefix layers")]
    return next((why for hit, why in causes if hit), None)


def supports_pp(cfg: ArchConfig) -> bool:
    """Homogeneous dense stacks only (no in-layer collectives of its own, no
    prefix)."""
    return _unsupported(cfg) is None


def _stages(cfg: ArchConfig, mesh) -> int:
    why = _unsupported(cfg)
    if why is not None:
        raise ValueError(f"{cfg.name}: pipeline parallelism takes homogeneous dense stacks, "
                         f"and {why}")
    if "stage" not in mesh.shape:
        raise ValueError(f"a pipeline needs a mesh with a `stage` axis; {mesh} has none")
    n = mesh.shape["stage"]
    if cfg.n_scan_groups % n:
        raise ValueError(f"{cfg.name}: {cfg.n_scan_groups} layer groups do not split over "
                         f"{n} stages")
    return n


def _check_rows(rows: int, microbatches: int, mesh) -> None:
    if rows % microbatches:
        dp = parallel.data_size(mesh, data_axes_of(mesh))
        raise ValueError(f"a batch of {rows * dp} rows does not split into {microbatches} "
                         f"microbatches over {dp} data-parallel ranks")


def _tagged(params, plans):
    """The parameter blocks, each a leaf tagged with its plan for
    `parallel.gather` (a view where the block has none)."""
    out = []
    for t, plan in zip(tree_lib.leaves(params), plans):
        if getattr(t, "_plan", None) is None:
            t = t.view_as(t)
            t._plan = plan
        out.append(t)
    return tree_lib.unflatten(params, out)


def _stage_forward(groups: list, x: torch.Tensor, cfg: ArchConfig, ctx: blocks.RunCtx,
                   first: int) -> torch.Tensor:
    """This stage's layer groups in order (no remat, as the reference's
    scan); group i is absolute group first + i."""
    for i, gp in enumerate(groups):
        x, _, _ = blocks.apply_group_full(gp, x, cfg, ctx, False, first + i)
    return x


def pp_forward(params, tokens: torch.Tensor, cfg: ArchConfig, mesh, microbatches: int,
               ctx: Optional[blocks.RunCtx] = None) -> torch.Tensor:
    """Pipelined forward -> the logits of this rank's rows, on every stage
    (this model rank's vocabulary slice where the vocabulary splits, as
    `lm.forward` on a mesh).

    params: this rank's `pp_param_pspecs` blocks; tokens: its rows (b, l),
    microbatch-major (`steps.local_batch`), b a multiple of microbatches.
    ctx: the layers' run context (the mesh's, q_block 512, by default).
    Across stages the forward is not differentiable here: its hops would
    need every stage to run their backwards in one order, which the train
    step (`make_pp_train_step`) schedules itself."""
    n_stages = _stages(cfg, mesh)
    rows, seq = tokens.shape
    _check_rows(rows, microbatches, mesh)
    params = _tagged(params, steps.leaf_plans(cfg, mesh, PP_OVERRIDES))
    if n_stages > 1 and torch.is_grad_enabled() and any(
            t.requires_grad for t in tree_lib.leaves(params)):
        raise ValueError("pp_forward is not differentiable across stages: train with "
                         "make_pp_train_step")
    ctx = ctx if ctx is not None else steps._run_ctx(cfg, mesh)
    s, n_local = parallel.coord("stage", mesh), cfg.n_scan_groups // n_stages
    top = lm.top_level(params, mesh)
    groups = lm.stacked_slices(params["groups"], n_local)
    mb = rows // microbatches
    x = common.embed_lookup(top["embed"], tokens, mesh) if s == 0 else None
    buf = torch.zeros((mb, seq, cfg.d_model), dtype=params["embed"].dtype,
                      device=tokens.device)
    outs = []
    for t in range(microbatches + n_stages - 1):
        recv = parallel.stage_hop(buf, mesh)
        m = t - s
        if 0 <= m < microbatches:
            cur = x[m * mb:(m + 1) * mb] if s == 0 else recv
            buf = _stage_forward(groups, cur, cfg, ctx, s * n_local)
            if s == n_stages - 1:
                outs.append(buf)
    y = torch.cat(outs) if outs else buf.new_empty((rows, seq, cfg.d_model))
    return lm.unembed(top, cfg, parallel.from_last_stage(y, mesh), mesh)


def make_pp_train_step(cfg: ArchConfig, mesh, microbatches: int = 4,
                       opt_cfg: Optional[adamw.AdamWConfig] = None, q_block: int = 512, *,
                       param_dtype=torch.bfloat16):
    """Pipelined train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), each this rank's blocks (`pp_placements`) and the batch its
    rows (`steps.local_batch(batch, mesh, microbatches)`); updated in place,
    as `steps.make_train_step`'s.  The metrics: {"loss", "grad_norm", "lr"}.

    The schedule is GPipe, written out: every microbatch forward, stage to
    stage (`parallel.stage_shift`), each stage keeping each microbatch's
    input and output; the last stage unembeds the whole batch's outputs
    and takes the cross entropy over them, as the reference's loss; then
    every microbatch backward in reverse, each stage sending its input's
    gradient to the previous stage, and stage 0 the embedding's backward.
    Every rank issues its sends and receives in one order, each tick.

    A stage's group gradients add over the microbatches in f32
    (`steps._accumulate`'s rule; the reference sums bf16 in its scan's
    transpose).  The replicated leaves' gradients (the embedding on stage
    0, the final norm and the unembedding on the last; a tied embedding
    takes both, summed in f32 and rounded once as autograd's bf16 sum
    rounds) sum over `stage` before the ZeRO-1 reductions, and AdamW
    updates the blocks in place (`steps.mesh_update`)."""
    n_stages = _stages(cfg, mesh)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    ctx = steps._run_ctx(cfg, mesh, q_block)
    plans = steps.leaf_plans(cfg, mesh, PP_OVERRIDES)
    to_zero1, update = steps.mesh_update(mesh, opt_cfg, plans, param_dtype)
    names = [n for n, _ in tree_lib.named_leaves(registry.schema(cfg))]
    group_idx = [i for i, n in enumerate(names) if n.startswith("groups/")]
    top_idx = [i for i, n in enumerate(names) if not n.startswith("groups/")]
    s, n_local = parallel.coord("stage", mesh), cfg.n_scan_groups // n_stages
    first, last = s == 0, s == n_stages - 1
    M, ticks = microbatches, microbatches + n_stages - 1

    def train_step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        rows, seq = tokens.shape
        _check_rows(rows, M, mesh)
        mb = rows // M
        leaves = []
        for t, plan in zip(tree_lib.leaves(params), plans):
            leaf = t.detach().requires_grad_(True)
            leaf._plan = plan
            leaves.append(leaf)
        p = tree_lib.unflatten(params, leaves)
        group_leaves = [leaves[i] for i in group_idx]
        top_leaves = [leaves[i] for i in top_idx]
        grads = [None] * len(leaves)

        def add_top(parts):        # a tied embedding meets its two uses here
            for i, g in zip(top_idx, parts):
                if g is not None:
                    grads[i] = g if grads[i] is None else (grads[i].float() + g.float()).to(g.dtype)

        with torch.enable_grad():
            # forward: stage s runs microbatch t - s at tick t
            if first:
                x = common.embed_lookup(parallel.gather(p["embed"], mesh), tokens, mesh)
                x_in = x.detach()
            buf = torch.zeros((mb, seq, cfg.d_model), dtype=p["embed"].dtype,
                              device=tokens.device)
            ins, outs = [None] * M, [None] * M
            for t in range(ticks):
                recv = parallel.stage_shift(buf, mesh)
                m = t - s
                if 0 <= m < M:
                    inp = x_in[m * mb:(m + 1) * mb] if first else recv
                    ins[m] = inp.detach().requires_grad_(True)
                    outs[m] = _stage_forward(lm.stacked_slices(p["groups"], n_local), ins[m],
                                             cfg, ctx, s * n_local)
                    buf = outs[m].detach()

            # the loss over the whole batch's outputs, on the last stage
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            if last:
                y = torch.cat([o.detach() for o in outs]).requires_grad_(True)
                logits = lm.unembed(lm.top_level(p, mesh), cfg, y, mesh)
                loss = common.cross_entropy_loss(
                    logits, labels, batch.get("mask"),
                    vocab_offset=lm.vocab_offset(cfg, logits.shape[-1], mesh), mesh=mesh,
                    data_axes=ctx.data_axes)
                g_y, *g_top = torch.autograd.grad(loss, [y] + top_leaves, allow_unused=True)
                add_top(g_top)
                g_outs = g_y.split(mb)
                loss = loss.detach()
                del logits

            # backward: stage s runs microbatch M - 1 - (u - (S - 1 - s)) at tick u
            acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                   for t in group_leaves]
            g_in, gbuf = [None] * M, torch.zeros_like(buf)
            for u in range(ticks):
                recv = parallel.stage_shift(gbuf, mesh, reverse=True)
                k = u - (n_stages - 1 - s)
                if 0 <= k < M:
                    m = M - 1 - k
                    gbuf, *g_groups = torch.autograd.grad(
                        outs[m], [ins[m]] + group_leaves, g_outs[m] if last else recv,
                        allow_unused=True)
                    for a, g in zip(acc, g_groups):
                        if g is not None:
                            a.add_(g)
                    ins[m] = outs[m] = None
                    if first:
                        g_in[m] = gbuf
            if first:
                add_top(torch.autograd.grad(x, top_leaves, torch.cat(g_in), allow_unused=True))
        for i, a in zip(group_idx, acc):
            grads[i] = a

        for axis in reversed(ctx.data_axes):
            loss = parallel.all_reduce(loss, mesh, axis)
        loss = parallel.from_last_stage(loss, mesh)
        zero1 = [to_zero1(torch.zeros_like(t) if g is None else g, plan)
                 for t, g, plan in zip(leaves, grads, plans)]
        del leaves, p, grads, acc
        params, opt_state, opt_met = update(params, opt_state, zero1)
        return params, opt_state, {"loss": loss, **opt_met}

    return train_step


def pp_param_pspecs(cfg: ArchConfig, mesh):
    """The parameters' specs on a pipeline mesh: the default rules with the
    layer stack over `stage` (the reference's `pp_param_shardings`)."""
    return shd.param_pspecs(cfg, mesh, PP_OVERRIDES)


def pp_placements(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """What each rank holds of a pipelined step's inputs (the port's form of
    the reference's `pp_lowering_inputs`): `steps.train_placements` with
    the layer stack over `stage`, for the parameters and the ZeRO-1
    state."""
    return steps.train_placements(cfg, shape, mesh, PP_OVERRIDES)
