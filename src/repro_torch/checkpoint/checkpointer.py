"""Fault-tolerant checkpointer (port of `repro.checkpoint.checkpointer`),
with the reference's on-disk layout, so that a checkpoint written by either
package restores in the other:

  * `step_%010d/manifest.json` plus one `leaf_%05d.npy` per leaf, the
    leaves in the reference's flatten order and named by their paths
    (`repro_torch.tree`);
  * bfloat16 leaves stored as their raw 16-bit words (uint16) with
    `"dtype": "bfloat16"` in the manifest: the words cross through
    `tensor.view(torch.int16)`, with no bf16 numpy type;
  * atomic publish: written to `step_%010d.tmp/`, the manifest fsynced,
    then renamed, so a crash mid-write never leaves a partial checkpoint;
  * async save: `save()` copies the tree to host memory at once and writes
    it in a background thread; the thread's error surfaces at the next
    `wait()` (or `save()`).  A blocking save copies no whole tree: each
    device leaf goes through one pinned buffer into its file;
  * keep-k GC and `latest()` resume discovery; metadata (the data
    pipeline's state, the step) as JSON;
  * on a mesh (`mesh` and a tree of `launch.sharding` specs, given to the
    constructor or to `restore`) the files stay the full logical leaves:
    every rank takes part in gathering each leaf (`sharding.assemble`) and
    rank 0 writes it; a restore maps each file and takes the rank's block.
    So a checkpoint moves between world sizes and between the packages.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

def _host_copy(x) -> Any:
    """A host snapshot of one leaf that later device work cannot change."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _staging(tree) -> Optional[torch.Tensor]:
    """A pinned host buffer as large as the tree's largest device leaf (None
    without one): a blocking save copies each device leaf through it."""
    sizes = [t.numel() * t.element_size() for t in tree_lib.leaves(tree)
             if isinstance(t, torch.Tensor) and t.device.type != "cpu"]
    return torch.empty(max(sizes), dtype=torch.uint8, pin_memory=True) if sizes else None


def _on_host(x, staging: Optional[torch.Tensor]):
    """A leaf readable on the host: a device tensor copied into `staging`
    (valid until the next leaf's copy), anything else as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    if x.device.type == "cpu":
        return x.detach()
    out = staging[:x.numel() * x.element_size()].view(x.dtype).view(x.shape)
    return out.copy_(x.detach())


def _to_savable(x) -> Tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    return x, x.dtype.name


def _from_savable(x: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, mesh=None, specs=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.mesh, self.specs = mesh, specs
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _writer(self) -> bool:
        import torch.distributed as dist
        return self.mesh is None or not dist.is_initialized() or dist.get_rank() == 0

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot now, write asynchronously; or, blocking, write each leaf
        straight from where it lies (a device leaf through one pinned
        buffer): no host copy of the whole tree, which at tens of GB costs
        as much again as the write."""
        self.wait()  # one in-flight save at a time
        if self.mesh is not None:
            from repro_torch.launch import sharding as shd
            tree = shd.assemble_tree(tree, self.specs, self.mesh)
            if not self._writer():
                return
        if blocking:
            self._write(step, tree, metadata or {})
            return
        host_tree = tree_lib.tree_map(_host_copy, tree)
        self._thread = threading.Thread(
            target=self._write_guard, args=(step, host_tree, metadata or {}), daemon=True)
        self._thread.start()

    def _write_guard(self, step, tree, metadata):
        try:
            self._write(step, tree, metadata)
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def _write(self, step: int, tree: Any, metadata: Dict) -> None:
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "metadata": metadata, "leaves": []}
        staging = _staging(tree)
        for i, (name, leaf) in enumerate(tree_lib.named_leaves(tree)):
            fname = f"leaf_{i:05d}.npy"
            raw, dtype_name = _to_savable(_on_host(leaf, staging))
            np.save(tmp / fname, raw)
            manifest["leaves"].append({"name": name, "file": fname,
                                       "shape": list(raw.shape), "dtype": dtype_name})
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: Any, specs=None, mesh=None
                ) -> Tuple[Any, Dict]:
        """Restore into the structure of `target_tree`: each leaf takes the
        device of the target's leaf at its place and its dtype, but for a
        leaf saved in bf16 where the target holds f32, which keeps bf16.
        (AdamW hands every parameter back in bf16, the f32 MoE router too,
        so a fresh tree's router is f32 and a trained one's bf16.  The
        reference casts to the target's dtype: a resumed MoE run then takes
        f32 router gradients where the uninterrupted run took bf16 ones,
        and is not bitwise that run.)  Any other dtype that differs from
        the target's raises.  Each file is mapped copy-on-write: a host
        target's leaf reads its pages when first used, and a device
        target's copies from the mapping with no host copy between.

        On a mesh (`mesh` and `specs`, or the constructor's) each target
        leaf is this rank's block of the saved leaf, or the whole leaf; the
        restore takes the block (a contiguous copy where it splits)."""
        from repro_torch.launch import sharding as shd

        mesh = mesh if mesh is not None else self.mesh
        specs = specs if specs is not None else self.specs
        spec_list = (shd.spec_leaves(specs) if mesh is not None
                     else [None] * len(tree_lib.leaves(target_tree)))
        path = self.dir / f"step_{step:010d}"
        manifest = json.loads((path / "manifest.json").read_text())
        targets = tree_lib.named_leaves(target_tree)
        records = manifest["leaves"]
        if len(targets) != len(records):
            raise ValueError(f"checkpoint has {len(records)} leaves, target {len(targets)}")
        leaves = []
        for (name, t), rec, spec in zip(targets, records, spec_list):
            want = (list(rec["shape"]) if spec is None
                    else list(shd.local_shape(rec["shape"], spec, mesh)))
            if rec["name"] != name or list(t.shape) not in (want, list(rec["shape"])):
                raise ValueError(f"checkpoint leaf {rec['name']} {rec['shape']} does not fit "
                                 f"the target's {name} {list(t.shape)}")
            x = _from_savable(np.load(path / rec["file"], mmap_mode="c"), rec["dtype"])
            if spec is not None:
                blk = shd.shard_of(x, spec, mesh)
                x = blk if blk.shape == x.shape else blk.contiguous().clone()
            if x.dtype != t.dtype and (x.dtype, t.dtype) != (torch.bfloat16, torch.float32):
                raise ValueError(f"checkpoint leaf {name} is {x.dtype}, the target's {t.dtype}")
            leaves.append(x.to(device=t.device))
        return tree_lib.unflatten(target_tree, leaves), manifest["metadata"]
