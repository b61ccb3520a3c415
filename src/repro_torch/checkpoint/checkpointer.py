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
    `wait()` (or `save()`);
  * keep-k GC and `latest()` resume discovery; metadata (the data
    pipeline's state, the step) as JSON.
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
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot now, write asynchronously (unless blocking)."""
        self.wait()  # one in-flight save at a time
        host_tree = tree_lib.tree_map(_host_copy, tree)
        if blocking:
            self._write(step, host_tree, metadata or {})
        else:
            self._thread = threading.Thread(
                target=self._write_guard, args=(step, host_tree, metadata or {}),
                daemon=True)
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
        for i, (name, leaf) in enumerate(tree_lib.named_leaves(tree)):
            fname = f"leaf_{i:05d}.npy"
            raw, dtype_name = _to_savable(leaf)
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

    def restore(self, step: int, target_tree: Any) -> Tuple[Any, Dict]:
        """Restore into the structure of `target_tree`: each leaf takes the
        dtype and device of the target's leaf at its place."""
        path = self.dir / f"step_{step:010d}"
        manifest = json.loads((path / "manifest.json").read_text())
        targets = tree_lib.named_leaves(target_tree)
        records = manifest["leaves"]
        if len(targets) != len(records):
            raise ValueError(f"checkpoint has {len(records)} leaves, target {len(targets)}")
        leaves = []
        for (name, t), rec in zip(targets, records):
            if rec["name"] != name or list(rec["shape"]) != list(t.shape):
                raise ValueError(f"checkpoint leaf {rec['name']} {rec['shape']} does not fit "
                                 f"the target's {name} {list(t.shape)}")
            x = _from_savable(np.load(path / rec["file"]), rec["dtype"])
            leaves.append(x.to(device=t.device, dtype=t.dtype))
        return tree_lib.unflatten(target_tree, leaves), manifest["metadata"]
