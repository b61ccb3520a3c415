"""Checkpoints on a mesh, elastic restore and the training CLI's `--mesh`,
over gloo on the CPU.

  * A checkpoint of yi-6b smoke's training state after 3 steps at 2 x 2 (4
    ranks; `tests/mesh_worker.py`): the same manifest and the same bytes,
    file for file, as the one-process checkpointer writes for that state,
    which equals the state the ranks held; `remesh_restore` at 2 x 1 (2
    ranks, each its blocks) and at 1 x 1 gives every leaf bitwise; the
    JAX package's `Checkpointer` restores it bitwise.
  * `python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train --device cpu --mesh 2x1 --arch smollm-360m
    --smoke` trains 12 steps; the same with a failure injected at step 7
    resumes from its step-5 checkpoint and prints the uncrashed run's
    losses; the 1 x 1 CLI's losses agree within 2e-3 relative (the
    printed 4 decimals; the data-parallel sum of bf16 gradient parts,
    `tests/test_torch_mesh_step.py`).  A mesh whose size is not the world
    size raises, naming both.
  * `repro_torch.examples.train_tiny_lm` with and without `--crash`: the
    resumed run's losses and final state equal the uncrashed run's bitwise.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs, tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.models import registry
from repro_torch.optim import adamw_init
from tests import mesh_worker as mw
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
CLI = ["--device", "cpu", "--arch", "smollm-360m", "--smoke", "--steps", "12", "--batch", "4",
       "--seq-len", "32", "--checkpoint-every", "5"]
CLI_LOSS_REL = 2e-3


@pytest.fixture(scope="module")
def mesh_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    wrote = mw.launch(4, d / "w4.pkl", [f"ckpt_write:{d / 'ckpt'}"])[f"ckpt_write:{d / 'ckpt'}"]
    job = f"ckpt_restore:{d / 'ckpt'}:2x1"
    restored = mw.launch(2, d / "w2.pkl", [job])[job]
    return d, wrote, restored


def _template(seed=1):
    cfg = configs.get_arch("yi-6b", smoke=True)
    params = registry.materialize_params(cfg, seed, device="cpu")
    return cfg, (params, adamw_init(params))


def _one_process_state(d):
    _, like = _template()
    return Checkpointer(d / "ckpt").restore(mw.STEPS, like)[0]


def test_mesh_checkpoint_equals_one_process_checkpoint(mesh_ckpt):
    d, wrote, _ = mesh_ckpt
    state = _one_process_state(d)
    # the files hold what the ranks held
    for (name, got), (_, want) in zip(mw.as_numpy(state), wrote["state"]):
        assert np.array_equal(got, want), name
    Checkpointer(d / "one").save(mw.STEPS, state, {"step": mw.STEPS}, blocking=True)
    a, b = d / "ckpt" / f"step_{mw.STEPS:010d}", d / "one" / f"step_{mw.STEPS:010d}"
    ma, mb = (json.loads((p / "manifest.json").read_text()) for p in (a, b))
    assert ma["leaves"] == mb["leaves"] and ma["metadata"] == mb["metadata"]
    for rec in ma["leaves"]:
        assert (a / rec["file"]).read_bytes() == (b / rec["file"]).read_bytes(), rec["name"]


def test_remesh_restore_at_2x1_is_bitwise(mesh_ckpt):
    d, _, restored = mesh_ckpt
    for (name, got), (_, want) in zip(restored["state"], mw.as_numpy(_one_process_state(d))):
        assert np.array_equal(got, want), name
    assert restored["meta"] == {"step": mw.STEPS}
    cfg, (params, _) = _template()
    names = [n for n, _ in tree.named_leaves(params)]
    shapes = dict(zip(names, restored["local_shapes"]))
    e = cfg.d_model
    assert shapes["embed"] == (params["embed"].shape[0], e // 2)      # embed -> data
    assert shapes["groups/sub0/attn/wq"][1] == cfg.d_model // 2


def test_remesh_restore_at_1x1_is_bitwise(mesh_ckpt):
    import torch.distributed as dist
    from repro_torch.runtime.elastic import remesh_restore

    d, _, _ = mesh_ckpt
    cfg, like = _template()
    try:
        state, meta, mesh = remesh_restore(Checkpointer(d / "ckpt"), cfg, like, (1, 1),
                                           ("data", "model"), device_type="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert mesh.shape == {"data": 1, "model": 1} and meta == {"step": mw.STEPS}
    for (name, got), (_, want) in zip(mw.as_numpy(state), mw.as_numpy(_one_process_state(d))):
        assert np.array_equal(got, want), name


def test_jax_checkpointer_restores_the_mesh_checkpoint(mesh_ckpt):
    import jax
    from repro import configs as jconfigs
    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.models import registry as jregistry
    from repro.optim import adamw_init as jadamw_init

    d, _, _ = mesh_ckpt
    jcfg = jconfigs.get_arch("yi-6b", smoke=True)
    jparams = jax.device_get(jregistry.materialize_params(jcfg, seed=1))
    jstate, _ = JCheckpointer(d / "ckpt").restore(mw.STEPS, (jparams, jadamw_init(jparams)))
    port = tree.leaves(_one_process_state(d))
    for want, got in zip(port, jax.tree_util.tree_leaves(jstate)):
        got = np.asarray(got)
        want = (want.view(torch.int16).numpy() if want.dtype == torch.bfloat16
                else want.numpy())
        assert got.tobytes() == want.tobytes()


def _torchrun(args, nproc=2):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(mw.ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                           str(nproc), "--master-addr", "127.0.0.1", "--master-port",
                           str(mw.free_port()), "-m", "repro_torch.launch.train", *args],
                          cwd=mw.ROOT, env=env, capture_output=True, text=True, timeout=300)


def _losses(out: str) -> dict:
    return {int(s): float(v) for s, v in re.findall(r"step\s+(\d+) loss=([0-9.]+)", out)}


def test_cli_trains_crashes_and_resumes_on_a_mesh(tmp_path, monkeypatch):
    from repro_torch.launch import train

    full = _torchrun(CLI + ["--mesh", "2x1", "--checkpoint-dir", str(tmp_path / "a")])
    assert full.returncode == 0, full.stderr[-3000:]
    assert full.stdout.count("[train] smollm-360m start_step=0") == 1     # rank 0 alone prints
    crash = _torchrun(CLI + ["--mesh", "2x1", "--checkpoint-dir", str(tmp_path / "b"),
                             "--fail-at", "7"])
    assert crash.returncode != 0 and "injected failure at step 7" in crash.stderr
    resumed = _torchrun(CLI + ["--mesh", "2x1", "--checkpoint-dir", str(tmp_path / "b")])
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "start_step=5" in resumed.stdout
    mesh_losses, resumed_losses = _losses(full.stdout), _losses(resumed.stdout)
    assert sorted(mesh_losses) == [1, 2, 3, 10] and sorted(resumed_losses) == [10]
    assert resumed_losses[10] == mesh_losses[10]
    final = re.findall(r"final loss=([0-9.]+)", full.stdout + "\n" + resumed.stdout)
    assert len(final) == 2 and final[0] == final[1]
    # the 1 x 1 CLI, in process
    seen = {}
    monkeypatch.setattr(train, "_print_metrics", lambda step, m: seen.setdefault(step, m["loss"]))
    train.main(CLI + ["--mesh", "1x1", "--checkpoint-dir", str(tmp_path / "c")])
    for step, loss in mesh_losses.items():
        assert abs(loss - seen[step]) <= CLI_LOSS_REL * seen[step], (step, loss, seen[step])


def test_cli_refuses_a_mesh_of_another_size(tmp_path, monkeypatch):
    from repro_torch.launch import train

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs 4 processes, but WORLD_SIZE is 1"):
        train.main(CLI + ["--mesh", "2x2", "--checkpoint-dir", str(tmp_path)])


def test_train_tiny_lm_example_resumes_bitwise(tmp_path, monkeypatch):
    from repro_torch.examples import train_tiny_lm
    from repro_torch.launch import train

    runs = []
    for crash in (False, True):
        seen = []
        monkeypatch.setattr(train, "_print_metrics", lambda step, m: seen.append((step, m)))
        argv = ["--device", "cpu", "--steps", "12", "--seq-len", "32",
                "--checkpoint-dir", str(tmp_path / str(crash))] + (["--crash"] if crash else [])
        state = train_tiny_lm.main(argv)
        runs.append((seen, state))
    (plain, s0), (crashed, s1) = runs
    # the crashed run: steps 1..5 (crash at 6, checkpoint at 4), then 5..12 resumed
    assert [s for s, _ in crashed][:5] == [1, 2, 3, 4, 5]
    last = {s: m for s, m in crashed}
    assert [m for s, m in plain if s == 12] == [last[12]]
    assert plain[-1][1]["loss"] == crashed[-1][1]["loss"]
    for a, b in zip(tree.leaves(s0), tree.leaves(s1)):
        assert torch.equal(a, b)
