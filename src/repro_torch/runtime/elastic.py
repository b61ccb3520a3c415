"""Elastic re-scale: restart a job on another device count (port of
`repro.runtime.elastic`).

Checkpoints hold the full logical leaves (`checkpoint.checkpointer`), so
elasticity is: build the new mesh, derive each leaf's spec from the same
logical-axis rules, and let each rank take its block of every file.  The
data pipeline resumes from its integer state; the rows a rank takes of
each global batch follow from the new mesh (`launch.steps.local_batch`).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd


def remesh_restore(ckpt: Checkpointer, cfg: ArchConfig, target_tree: Any,
                   new_mesh_shape: Tuple[int, ...], new_mesh_axes: Tuple[str, ...],
                   step: Optional[int] = None, device_type: str = "cuda"):
    """Restore the latest (or given) checkpoint onto a new mesh shape, on
    the card unless device_type is "cpu" (`launch.mesh.make_mesh`).

    target_tree: a parameter tree, or a training state (params, AdamWState),
    whose leaves (full leaves or this rank's blocks) give each restored
    leaf's device and dtype.  Returns (state on the new mesh, metadata,
    the new mesh)."""
    from repro_torch.launch import steps as steps_lib

    mesh = mesh_lib.make_mesh(new_mesh_shape, new_mesh_axes, device_type)
    step = ckpt.latest() if step is None else step
    if step is None:
        raise FileNotFoundError("no checkpoint to restore")
    specs = (shd.param_pspecs(cfg, mesh) if isinstance(target_tree, dict)
             else steps_lib.state_specs(cfg, mesh))
    state, meta = ckpt.restore(step, target_tree, specs=specs, mesh=mesh)
    return state, meta, mesh
