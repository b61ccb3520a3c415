"""Carry the JAX package's parameters into the port.

`from_jax_params` takes the reference's parameter tree as numpy arrays (after
`jax.device_get`) and returns the same tree of torch tensors, layout and
dtype kept: every leaf of the port's schema, the SSM layers' `ssm.*` weights
and a stacked hybrid group (Jamba's eight sub-layers) included.  bfloat16 arrives as `ml_dtypes.bfloat16` numpy, which torch
cannot read directly, so it crosses as raw 16-bit words.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, registry


def _to_torch(a: np.ndarray, want: common.ParamDef, device) -> torch.Tensor:
    if tuple(a.shape) != tuple(want.shape):
        raise ValueError(f"shape {a.shape} != schema {want.shape}")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if t.dtype != want.dtype:
        raise ValueError(f"dtype {t.dtype} != schema {want.dtype}")
    return t.to(device)


def from_jax_params(tree, cfg: ArchConfig, device="cuda"):
    """Numpy tree in the reference's layout -> torch tree on `device`,
    checked leaf by leaf against the port's schema for `cfg`."""

    def walk(node, sch, path):
        if isinstance(sch, common.ParamDef):
            try:
                return _to_torch(np.asarray(node), sch, device)
            except ValueError as e:
                raise ValueError(f"param {path}: {e}") from None
        if set(node) != set(sch):
            raise ValueError(f"param {path or '<root>'}: keys {sorted(node)} != {sorted(sch)}")
        return {k: walk(node[k], sch[k], f"{path}.{k}" if path else k) for k in sch}

    return walk(tree, registry.schema(cfg), "")
