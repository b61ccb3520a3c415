"""Device meshes of the port (port of `repro.launch.mesh`).

Functions only: importing this module touches no process group.  A mesh
is a `torch.distributed.device_mesh.DeviceMesh` with the reference's axis
names, wrapped in `Mesh`, which answers the questions the sharding rules
and the collectives ask: the axis names, each axis's size (`shape`, a dict
as the reference's `mesh.shape`), this rank's coordinate on an axis and the
axis's process group.  Processes come from `torchrun` (or a caller that
initialises the default process group itself); `init_distributed` starts
the default group from torchrun's environment, or, at world size 1, from
an in-memory `HashStore` with no socket.  The backend is NCCL for CUDA
devices and gloo for the CPU.  A mesh is on the card unless the caller
asks for the CPU (`device_type="cpu"`); without a card it raises.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple


class Mesh:
    """A named device mesh: `axis_names`, `shape` ({axis: size}), `size`,
    `coord(axis)` (this rank's index on the axis), `group(axis)` (the
    process group of this rank's line along the axis)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.size = math.prod(self.shape.values())
        self.device_type = device_mesh.device_type

    def coord(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return f"Mesh({self.shape})"


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _require(device_type: str) -> None:
    import torch
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on the card needs CUDA, and none is available "
                           "(pass device_type='cpu' for a gloo mesh on the CPU)")


def init_distributed(device_type: str = "cuda") -> Tuple[int, int]:
    """Start the default process group if none is up; returns (rank, world
    size).  Under torchrun (WORLD_SIZE and MASTER_ADDR set) it reads the
    environment; otherwise it is a world of one over a `HashStore`."""
    import torch.distributed as dist

    _require(device_type)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        backend = backend_for(device_type)
        if world == 1 and "MASTER_ADDR" not in os.environ:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method="env://")
        if device_type == "cuda":
            import torch
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return dist.get_rank(), dist.get_world_size()


def make_mesh(shape, axes, device_type: str = "cuda") -> Mesh:
    """A mesh of `shape` named `axes` over the default process group, whose
    size must be the product of `shape` (elastic re-scale, tests); on the
    card (NCCL) unless device_type is "cpu" (gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    init_distributed(device_type)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {math.prod(shape)} "
                         f"processes; the world has {dist.get_world_size()}")
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=axes))


# the production meshes: (shape, axes)
PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> Mesh:
    return make_mesh(*PRODUCTION["multi" if multi_pod else "single"], device_type)


def make_pp_mesh(stages: int = 4, data: int = 8, model: int = 8,
                 device_type: str = "cuda") -> Mesh:
    """The pipeline's mesh (`launch.pipeline`): a one-axis ("stage",) mesh
    when data = model = 1, else ("stage", "data", "model")."""
    if data == 1 and model == 1:
        return make_mesh((stages,), ("stage",), device_type)
    return make_mesh((stages, data, model), ("stage", "data", "model"), device_type)


def parse_mesh(spec: str):
    """A CLI's --mesh -> (shape, axes), None for 1x1: `DxM` over ("data",
    "model"), or a production mesh by name (`single`, `multi`)."""
    if spec == "1x1":
        return None
    if spec in PRODUCTION:
        return PRODUCTION[spec]
    d, m = (int(t) for t in spec.split("x"))
    return (d, m), ("data", "model")


def mesh_of_flag(spec: str, device_type: str):
    """The mesh of a CLI's --mesh (None for 1x1) over torchrun's processes;
    its size must be WORLD_SIZE."""
    layout = parse_mesh(spec)
    if layout is None:
        return None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if math.prod(layout[0]) != world:
        raise ValueError(f"--mesh {spec} needs {math.prod(layout[0])} processes, but "
                         f"WORLD_SIZE is {world} (start them with torchrun "
                         f"--nproc-per-node {math.prod(layout[0])})")
    return make_mesh(*layout, device_type=device_type)


def data_axes_of(mesh) -> tuple:
    """Mesh axes that carry pure data parallelism (pod extends data; a
    pipeline's `stage` is none)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis_of(mesh) -> str:
    return "model"
