"""Logical-axis sharding rules of the port (port of `repro.launch.sharding`).

Parameters carry logical axis names (`models.common.ParamDef.axes`);
`DEFAULT_RULES` maps them to mesh axes.  A spec is a tuple with one entry
per dim: None (replicated), a mesh-axis name, or a tuple of names (the
batch over the data axes) -- the parts of the reference's `PartitionSpec`.
A dim that does not divide its axis's size, or whose axis an earlier dim
already took, is replicated (`spec_from_axes`).  `shard_of` cuts a full
tensor down to this rank's block of a spec, `assemble` gathers the blocks
of every rank back into the full tensor.

The cache half: `cache_pspecs` gives each leaf of one cache element (a
`MixedKVCache` or an `ssm.SSMState`) its spec by the reference's
size-matching rule -- rows over the data axes, then a kv-head, SSM-head or
`d_inner` dim over `model` where it divides, else a slot dim of 128 or
more (the split-KV).  `full_cache_pspecs` walks a whole cache tree
(`registry.map_caches`: the prefix layers, the groups, the SSM states);
the port's groups are a list of per-group elements, so its specs lack the
reference's leading (replicated) stack dim.  `cache_shardings` places a
full cache tree: each leaf cut to this rank's block.  Serving holds every
parameter as its `SERVE_OVERRIDES` block (`serve_plans`, `shard_serve_params`);
the prefill keeps that one placement too (the reference lowers it with
`PREFILL_OVERRIDES`, which only moves memory).  The decode step computes
the heads, the MLP width and the vocabulary on each rank's block; the
prefill gathers them on use.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig

SLOT_SPLIT_MIN = 128    # the smallest slot dim `cache_pspecs` splits over `model`

# logical axis -> mesh axis (None = replicated).  "embed" -> data is the
# FSDP / ZeRO axis: weights and optimizer state shard over data, gathered
# on use, reduce-scattered on grad.
DEFAULT_RULES = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "expert_in": None,
    "moe_mlp": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "embed": "data",
    "embed_out": None,
    "latent": None,
    "rope_dim": None,
    "head_dim": None,
    "v_dim": None,
    "ssm_state_in": None,
    "conv": None,
    "layers": None,
    "stage": None,
}

# serving drops the data axis from the weights and shards the attention
# matrices of non-divisible head counts over head_dim instead
SERVE_OVERRIDES = {
    "embed": None,
    "head_dim": "model",
    "v_dim": "model",
}

# prefill keeps FSDP and extends it to the expert weights
PREFILL_OVERRIDES = {
    "expert_in": "data",
}


def rules_for_mesh(mesh, overrides: Optional[dict] = None) -> dict:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    # drop rules that reference axes the mesh doesn't have
    names = set(mesh.axis_names)
    return {k: (v if (v is None or (v in names if isinstance(v, str) else set(v) <= names)) else None)
            for k, v in rules.items()}


def axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape[axis]
    return math.prod(mesh.shape[a] for a in axis)


def spec_from_axes(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                   rules: dict, mesh) -> tuple:
    """Logical axes -> spec; non-divisible dims and reused axes replicate."""
    used = set()
    parts = []
    for ax, dim in zip(axes, shape):
        m = rules.get(ax) if ax is not None else None
        if m is not None and (m in used or dim % axis_size(mesh, m) != 0):
            m = None
        if m is not None:
            used.add(m)
        parts.append(m)
    return tuple(parts)


def _schema(cfg: ArchConfig):
    from repro_torch.models import registry
    return registry.schema(cfg)


def _map_defs(fn, schema):
    from repro_torch.models.common import ParamDef
    if isinstance(schema, ParamDef):
        return fn(schema)
    return {k: _map_defs(fn, v) for k, v in schema.items()}


def param_pspecs(cfg: ArchConfig, mesh, overrides: Optional[dict] = None):
    """The parameters' specs, a tree shaped as `registry.schema(cfg)`."""
    rules = rules_for_mesh(mesh, overrides)
    return _map_defs(lambda d: spec_from_axes(d.axes, d.shape, rules, mesh), _schema(cfg))


def zero1_pspecs(cfg: ArchConfig, mesh, overrides: Optional[dict] = None):
    """ZeRO-1 specs for the optimizer state (the f32 master, m and v): the
    parameter's spec plus 'data', then 'model', on the first dim that is
    still replicated and divides evenly, where the spec lacks the axis."""
    rules = rules_for_mesh(mesh, overrides)
    dsize = mesh.shape.get("data", 1)
    msize = mesh.shape.get("model", 1)

    def one(d):
        parts = list(spec_from_axes(d.axes, d.shape, rules, mesh))
        parts += [None] * (len(d.shape) - len(parts))
        for axis, size in (("data", dsize), ("model", msize)):
            if axis in parts or size <= 1:
                continue
            for i, (dim, pt) in enumerate(zip(d.shape, parts)):
                if pt is None and dim % size == 0 and dim >= size:
                    parts[i] = axis
                    break
        return tuple(parts)

    return _map_defs(one, _schema(cfg))


def batch_pspec(mesh) -> tuple:
    from repro_torch.launch.mesh import data_axes_of
    return (data_axes_of(mesh),)


def batch_shardings(spec_tree, mesh):
    """Specs of a batch's leaves (`{name: (shape, dtype)}` or tensors): dim 0
    over the data axes, replicated where the batch does not divide them."""
    from repro_torch.launch.mesh import data_axes_of

    daxes = data_axes_of(mesh)
    dp = axis_size(mesh, daxes)

    def one(s):
        shape = tuple(s[0]) if isinstance(s, tuple) else tuple(s.shape)
        b = shape[0] if shape else 0
        if b and b % dp == 0:
            return (daxes,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return {k: one(v) for k, v in spec_tree.items()}


# ---------------------------------------------------------------------------
# A rank's block of a spec
# ---------------------------------------------------------------------------

def block_index(part, mesh) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a dim split by `part`
    (an axis name or a tuple of them, the first the slowest)."""
    if part is None:
        return 0, 1
    axes = (part,) if isinstance(part, str) else tuple(part)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coord(a)
    return idx, axis_size(mesh, axes)


def local_shape(shape, spec, mesh) -> tuple:
    return tuple(d // axis_size(mesh, p) for d, p in zip(shape, tuple(spec) + (None,) * len(shape)))


def shard_of(full, spec, mesh):
    """This rank's block of a full tensor (a view; the tensor itself where
    the spec splits nothing)."""
    out = full
    for dim, part in enumerate(spec):
        idx, n = block_index(part, mesh)
        if n > 1:
            size = out.shape[dim] // n
            index = [slice(None)] * len(out.shape)
            index[dim] = slice(idx * size, (idx + 1) * size)
            out = out[tuple(index)]
    return out


def assemble(local, spec, mesh):
    """The full tensor from every rank's block (`shard_of`'s inverse): an
    all-gather along each split dim, over the dim's axes (all ranks take
    part; the tensor itself where the spec splits nothing)."""
    from repro_torch.models import parallel

    out = local
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        for a in reversed(axes):        # the fastest axis first
            out = parallel.all_gather_dim(out, dim, mesh, a)
    return out


def is_spec(x) -> bool:
    """A spec: a plain tuple of None, axis names and tuples of axis names
    (a scalar's is ())."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str)
                    or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
                    for e in x))


def spec_leaves(specs) -> list:
    """The specs of a spec tree in `tree.leaves` order (a spec tuple is a leaf)."""
    if is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for child in specs for s in spec_leaves(child)]


def assemble_tree(tree, specs, mesh):
    return tree_lib.unflatten(tree, [assemble(t, s, mesh) for t, s in
                                     zip(tree_lib.leaves(tree), spec_leaves(specs))])


# ---------------------------------------------------------------------------
# Caches: the reference's size-matching rule over a cache tree
# ---------------------------------------------------------------------------

def _leaf_spec(shape, global_batch: int, daxes: tuple, dp: int, mp: int, heads) -> tuple:
    """One cache leaf's spec: the batch-sized dim over the data axes (if it
    divides); after it, a head-sized dim (kv heads, SSM heads, d_inner)
    over `model` where it divides, else a slot dim of at least 128 slots
    that divides and is not the last of three or more."""
    parts: list = [None] * len(shape)
    batch_done = model_done = False
    for i, n in enumerate(shape):
        if not batch_done and n == global_batch and global_batch % dp == 0:
            parts[i] = daxes
            batch_done = True
            continue
        if batch_done and not model_done and mp > 1 and n % mp == 0 and (
                n in heads or (n >= SLOT_SPLIT_MIN and (i < len(shape) - 1 or len(shape) == 2))):
            parts[i] = "model"
            model_done = True
    return tuple(parts)


def cache_pspecs(cache_el, cfg: ArchConfig, mesh, global_batch: int, local_rows: bool = False):
    """The specs of one cache element's leaves: the element's dataclass tree
    with a spec tuple in place of each tensor (`kvcache.tree_map`).
    local_rows: the element holds one data rank's rows of the global batch
    (every leaf's first dim), read as the global batch."""
    from repro_torch.core import kvcache as kvc
    from repro_torch.launch.mesh import data_axes_of
    from repro_torch.models import ssm as ssm_mod

    daxes = data_axes_of(mesh)
    dp = axis_size(mesh, daxes)
    mp = mesh.shape.get("model", 1)
    heads = {max(cfg.n_kv_heads, 0)}
    if cfg.ssm or cfg.attn_layer_period:
        heads |= {ssm_mod.n_ssm_heads(cfg), ssm_mod.d_inner(cfg)}

    def shape(t):
        return (global_batch,) + tuple(t.shape[1:]) if local_rows else tuple(t.shape)

    return kvc.tree_map(lambda t: _leaf_spec(shape(t), global_batch, daxes, dp, mp, heads),
                        cache_el)


def full_cache_pspecs(caches, cfg: ArchConfig, mesh, global_batch: int):
    """The specs of a whole cache tree, element by element (the prefix
    layers, every group's sub-layers, SSM states alike)."""
    from repro_torch.models import registry
    return registry.map_caches(lambda el: cache_pspecs(el, cfg, mesh, global_batch), caches)


def cache_leaf_specs(cache_el, specs) -> list:
    """[(leaf, spec)] of one element and its spec tree, in field order."""
    from repro_torch.core import kvcache as kvc
    pairs = []
    kvc.tree_map(lambda t, s: pairs.append((t, s)) or t, cache_el, specs)
    return pairs


def shard_cache_element(el, specs, mesh, axes=None):
    """This rank's block of one cache element (its specs from `cache_pspecs`),
    each split leaf copied: a QuantizedTensor's logical shape follows its
    codes.  axes: only those mesh axes cut (None: all)."""
    from repro_torch.core import kvcache as kvc

    def keep(spec):
        if axes is None:
            return spec
        return tuple(p if p is not None and set((p,) if isinstance(p, str) else p) <= set(axes)
                     else None for p in spec)

    def cut(t, spec):
        out = shard_of(t, keep(spec), mesh)
        return out.clone() if out is not t else t

    return fix_logical_shapes(kvc.tree_map(cut, el, specs))


def fix_logical_shapes(el):
    """A cache element whose every QuantizedTensor takes its logical shape
    from its codes (the last dim unpacked; raw 16-bit codes are the
    values): what a block or a gathered element needs to dequantize."""
    import dataclasses

    from repro_torch.core import quant

    if isinstance(el, quant.QuantizedTensor):
        shape = tuple(el.codes.shape[:-1]) + (el.shape[-1],)
        return dataclasses.replace(el, shape=shape) if shape != tuple(el.shape) else el
    if dataclasses.is_dataclass(el):
        return dataclasses.replace(el, **{
            f.name: fix_logical_shapes(getattr(el, f.name))
            for f in dataclasses.fields(el) if dataclasses.is_dataclass(getattr(el, f.name))})
    return el


def cache_shardings(caches, cfg: ArchConfig, mesh, global_batch: int):
    """A full cache tree placed on the mesh: every element cut to this
    rank's block of `full_cache_pspecs` (the port's form of the reference's
    NamedShardings: what a `device_put` with them leaves on a device)."""
    from repro_torch.models import registry
    return registry.map_caches(
        lambda el: shard_cache_element(el, cache_pspecs(el, cfg, mesh, global_batch), mesh),
        caches)


# ---------------------------------------------------------------------------
# Serving: the parameters' placement
# ---------------------------------------------------------------------------

# the axes whose `model` blocks the decode step computes on their own
DECODE_SPLIT_AXES = ("heads", "kv_heads", "mlp", "vocab")


def serve_plans(cfg: ArchConfig, mesh) -> list:
    """The `parallel.LeafPlan` of every parameter leaf for serving, in
    flatten order: the `SERVE_OVERRIDES` spec (no FSDP; heads, or head_dim
    where the heads do not divide, over `model`).  The routed experts
    compute split in every program (the MoE's mesh semantics).  The decode
    step also computes split the leaves whose `model` block is heads, MLP
    width or vocabulary (`keep_decode`), the attention heads only where the
    cache splits by heads too (GQA's kv heads divide `model`; MLA's heads,
    its cache being whole).  Every other leaf, and every leaf in the
    prefill, is gathered whole on use."""
    from repro_torch.models import parallel
    defs = tree_lib.leaves(_schema(cfg))
    specs = spec_leaves(param_pspecs(cfg, mesh, SERVE_OVERRIDES))
    heads_ok = (cfg.n_heads if cfg.mla else cfg.n_kv_heads) % mesh.shape.get("model", 1) == 0

    def keep_decode(d, p) -> bool:
        axis = d.axes[p.index("model")] if "model" in p else None
        return d.split and axis in DECODE_SPLIT_AXES and (
            heads_ok or axis not in ("heads", "kv_heads"))

    return [parallel.LeafPlan(p, p, d.split and "experts" in d.axes, keep_decode(d, p))
            for d, p in zip(defs, specs)]


def shard_serve_params(params, cfg: ArchConfig, mesh):
    """This rank's serving blocks of full parameters (a copy where a leaf
    splits), each tagged with its plan for `parallel.gather` on use."""
    out = []
    for t, plan in zip(tree_lib.leaves(params), serve_plans(cfg, mesh)):
        blk = shard_of(t, plan.pspec, mesh)
        blk = blk.clone() if blk is not t else t.view_as(t)
        blk._plan = plan
        out.append(blk)
    return tree_lib.unflatten(params, out)
