"""The port's training CLI (`python -m repro_torch.launch.train`) on the
CPU, against the JAX package's `repro.launch.train.main` on the same
arguments (`tests/train_reference.py`: smollm-360m's smoke config, 20
steps, batch 4 x 32 tokens, lr 3e-4 under the cosine schedule, warmup
10), both from the reference's seeded parameters (the port's own draws
differ: its `materialize_params` is patched to carry the reference's in).

  * the loss falls by more than 0.2 over the 20 steps, as
    `tests/test_substrates.py::test_adamw_decreases_loss` requires of the
    reference;
  * the first step's loss within 1e-5 relative of the reference's and its
    gradient norm within 1e-3; every step's loss within 5e-3.  The two
    runs drift apart as this tiny model's training amplifies a few bf16
    ulps (its random init gives a loss of ~19 over near one-hot
    softmaxes): the largest loss gap over the 20 steps stays within twice
    the gap that a one-ulp nudge of 8 weights opens within the port
    itself.  Gradient norms past the first step are not held: the nudge
    alone moves them by up to 30%.  Readings (this image): the first
    step's loss equal, its gradient norm 2.0e-4 apart; the largest loss
    gap 2.4e-3 (step 19) against the nudge's 2.2e-3;
  * a run that fails at step 12 (`--fail-at`, checkpoints every 5) and a
    second invocation on the same checkpoint directory resume at step 10,
    and steps 11-20 equal the uninterrupted run's to the bit;
  * `--mesh 2x1` raises the ValueError naming ROADMAP item 15c;
  * every other family (MoE, MLA, SSM, Jamba, the encoder-decoder, llava's
    frontend) trains two steps through `main`, its checkpoint restored
    bitwise; an MoE run that fails at step 3 resumes bitwise;
  * `python -m repro_torch.launch.train --device cpu` runs as a process.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import convert
from repro_torch.launch import train
from tests import train_reference as tr
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tr.run(tmp_path_factory.mktemp("train_cli") / "refs.pkl", ["cli"])["cli"]


def _run(ref, argv, monkeypatch, nudge=False):
    """The port's main(argv) from the reference's parameters (with `nudge`,
    8 elements of one weight one bf16 ulp up); each step's metrics, as
    `_print_metrics` sees them."""
    seen = []

    def materialize(cfg, seed, device):
        params = convert.from_jax_params(ref["params0"], cfg, device=device)
        if nudge:
            params["groups"]["sub0"]["mlp"]["w_up"].view(-1).view(torch.int16)[:8] += 1
        return params

    monkeypatch.setattr(train.registry, "materialize_params", materialize)
    monkeypatch.setattr(train, "_print_metrics", lambda step, m: seen.append((step, dict(m))))
    train.main(argv)
    return seen


@pytest.fixture(scope="module")
def port_run(ref, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        return _run(ref, tr.CLI_ARGV + ["--device", "cpu", "--checkpoint-dir",
                                        str(tmp_path_factory.mktemp("ckpt"))], mp)


def _loss_gap(a, b) -> float:
    return max(abs(x["loss"] - y["loss"]) / y["loss"] for (_, x), (_, y) in zip(a, b))


def test_cli_loss_falls_and_matches_reference(ref, port_run, tmp_path, monkeypatch):
    want = ref["metrics"]
    assert [s for s, _ in port_run] == [s for s, _ in want] == list(range(1, 21))
    losses = [m["loss"] for _, m in port_run]
    assert losses[-1] < losses[0] - 0.2, losses[::6]
    first, exp = port_run[0][1], want[0][1]
    assert abs(first["loss"] - exp["loss"]) <= 1e-5 * exp["loss"]
    assert abs(first["grad_norm"] - exp["grad_norm"]) <= 1e-3 * exp["grad_norm"]
    for (step, got), (_, exp) in zip(port_run, want):
        assert abs(got["loss"] - exp["loss"]) <= 5e-3 * exp["loss"], step
        assert got["lr"] == pytest.approx(exp["lr"], rel=1e-6)
    nudged = _run(ref, tr.CLI_ARGV + ["--device", "cpu", "--checkpoint-dir", str(tmp_path)],
                  monkeypatch, nudge=True)
    assert _loss_gap(port_run, want) <= 2 * _loss_gap(port_run, nudged)


def test_cli_resumes_at_the_saved_step(ref, port_run, tmp_path, monkeypatch, capsys):
    argv = tr.CLI_ARGV + ["--device", "cpu", "--checkpoint-dir", str(tmp_path),
                          "--checkpoint-every", "5"]
    with pytest.raises(RuntimeError, match="injected failure at step 12"):
        _run(ref, argv + ["--fail-at", "12"], monkeypatch)
    capsys.readouterr()
    resumed = _run(ref, argv, monkeypatch)
    assert "start_step=10" in capsys.readouterr().out
    assert [s for s, _ in resumed] == list(range(11, 21))
    assert [m for _, m in resumed] == [m for _, m in port_run[10:]]


def test_cli_refuses_a_mesh(tmp_path, monkeypatch):
    """A mesh whose size is not the world size: the CLI raises, naming both
    (`tests/test_torch_mesh_elastic.py` trains on one under torchrun)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    base = ["--smoke", "--device", "cpu", "--checkpoint-dir", str(tmp_path)]
    with pytest.raises(ValueError, match="needs 2 processes, but WORLD_SIZE is 1"):
        train.main(["--arch", "smollm-360m", "--mesh", "2x1"] + base)


@pytest.mark.parametrize("arch", tr.FAMILY_ARCHS)
def test_cli_trains_every_family(arch, tmp_path, monkeypatch):
    """Two steps of `main` on each other family's smoke config, a checkpoint
    at step 2: the losses finite, the checkpoint's leaves named as the
    state's, restored bitwise."""
    from repro_torch import tree
    from repro_torch.checkpoint import Checkpointer

    seen = []
    monkeypatch.setattr(train, "_print_metrics", lambda step, m: seen.append(m["loss"]))
    state = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                        "--warmup", "1", "--batch", "2", "--seq-len", "32",
                        "--checkpoint-every", "2", "--checkpoint-dir", str(tmp_path)])
    assert len(seen) == 2 and all(torch.isfinite(torch.tensor(seen)))
    restored, meta = Checkpointer(tmp_path).restore(2, tree.tree_map(torch.empty_like, state))
    assert meta["step"] == 2
    for a, b in zip(tree.leaves(state), tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cli_resumes_an_moe_run_bitwise(tmp_path, monkeypatch):
    """DeepSeek-V2-Lite's smoke config (MLA + MoE): a run that fails at step 3
    with checkpoints every 2, resumed by a second invocation, ends bitwise
    where the uninterrupted run ends, its router in bf16 as AdamW left it
    (the checkpointer restores the saved dtype, not the fresh tree's f32)."""
    from repro_torch import tree

    argv = ["--arch", "deepseek-v2-lite-16b", "--smoke", "--device", "cpu", "--steps", "4",
            "--warmup", "1", "--batch", "2", "--seq-len", "32", "--checkpoint-every", "2"]
    seen = []
    monkeypatch.setattr(train, "_print_metrics", lambda step, m: seen.append((step, m)))
    want = train.main(argv + ["--checkpoint-dir", str(tmp_path / "ref")])
    ref_seen, seen[:] = list(seen), []
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        train.main(argv + ["--checkpoint-dir", str(tmp_path / "crash"), "--fail-at", "3"])
    seen[:] = []
    got = train.main(argv + ["--checkpoint-dir", str(tmp_path / "crash")])
    assert [s for s, _ in seen] == [3, 4] and [m for _, m in seen] == [m for _, m in ref_seen[2:]]
    assert got[0]["groups"]["sub0"]["moe"]["router"].dtype == torch.bfloat16
    for (name, a), b in zip(tree.named_leaves(want), tree.leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_cli_runs_as_a_process(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b", "--smoke",
         "--device", "cpu", "--steps", "3", "--batch", "2", "--seq-len", "16",
         "--checkpoint-dir", str(tmp_path)],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                       "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "start_step=0" in proc.stdout and "done at step 3" in proc.stdout
    assert torch.cuda.is_available() or "device=cpu" in proc.stdout
