"""Logical-axis sharding rules of the port (port of `repro.launch.sharding`,
its training half).

Parameters carry logical axis names (`models.common.ParamDef.axes`);
`DEFAULT_RULES` maps them to mesh axes.  A spec is a tuple with one entry
per dim: None (replicated), a mesh-axis name, or a tuple of names (the
batch over the data axes) -- the parts of the reference's `PartitionSpec`.
A dim that does not divide its axis's size, or whose axis an earlier dim
already took, is replicated (`spec_from_axes`).  `shard_of` cuts a full
tensor down to this rank's block of a spec, `assemble` gathers the blocks
of every rank back into the full tensor.

The cache specs (`cache_pspecs`, `full_cache_pspecs`) and the serving
meshes that use `SERVE_OVERRIDES` / `PREFILL_OVERRIDES` wait for serving
on a mesh (ROADMAP item 15c-ii).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig

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
