"""The JAX package's training runs that the port's training tests
(`tests/test_torch_train_*.py`) hold it to, computed in a child process.

Jobs:
  * `loss:<arch>` — the smoke config's seeded parameters (qwen2-7b with
    random QKV biases), one batch from a numpy seed, and
    `jax.value_and_grad(registry.loss_fn)` op by op: the loss, its metrics
    and every gradient leaf in flatten order;
  * `step:<grad_accum>` — smollm-360m's smoke config through
    `launch.steps.make_train_step(cfg, None, OPT, grad_accum, q_block=16)`
    for three steps on the synthetic pipeline's batches: each step's
    metrics, and the parameters and optimizer state after the last;
  * `cli` — `repro.launch.train.main(CLI_ARGV)`: every step's metrics (its
    `_print_metrics` hook records them) and the parameters it started from.

The runs (the train steps jitted, the loss op by op) have XLA's excess
precision and its algebraic simplifier off (`--xla_allow_excess_precision=false
--xla_disable_hlo_passes=algsimp`, read once per process): every bf16
operation then rounds on its own, as the port's do, and the forward pass
equals the port's but for a rare attention output whose f32 sums run in
another order (ROADMAP.md §3).  With the defaults, the jitted scan body
keeps f32 intermediates and the loss moves further off.

    python -m tests.train_reference OUT.pkl JOB [JOB ...]   (run() sets the flags)
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LOSS_ARCHS = ("yi-6b", "qwen2-7b", "smollm-360m")
LOSS_BATCH, LOSS_LEN = 2, 64
STEP_ARCH, STEP_SEQ, STEP_BATCH, STEP_SEED, STEP_Q_BLOCK, STEP_N = "smollm-360m", 32, 4, 1, 16, 3
STEP_OPT = dict(lr=1e-3, grad_clip=1.0)   # plus cosine_schedule(1, STEP_N)
CLI_ARGV = ["--arch", "smollm-360m", "--smoke", "--steps", "20", "--batch", "4",
            "--seq-len", "32"]


def loss_batch(vocab: int) -> dict:
    rng = np.random.default_rng(11)
    toks = rng.integers(0, vocab, (LOSS_BATCH, LOSS_LEN + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _params(jax, jreg, cfg, seed=0):
    from tests.configs_reference import with_random_bias
    with jax.threefry_partitionable(True):
        params = jax.device_get(jreg.materialize_params(cfg, seed))
    return with_random_bias(params) if cfg.qkv_bias else params


def _loss(arch):
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.models import registry as jreg

    cfg = configs.get_arch(arch, smoke=True)
    params = _params(jax, jreg, cfg)
    batch = loss_batch(cfg.vocab)
    # op by op: jitted whole, XLA's fusions round one bf16 logit of
    # smollm's batch otherwise than the op-by-op run (and the port) do
    fn = jax.value_and_grad(lambda p, b: jreg.loss_fn(p, b, cfg), has_aux=True)
    (loss, met), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"params": params, "batch": batch, "loss": float(loss),
            "metrics": {k: float(v) for k, v in met.items()},
            "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]}


def step_batches(pipeline_mod, vocab):
    pipe = pipeline_mod.TokenPipeline(pipeline_mod.DataConfig(
        seq_len=STEP_SEQ, global_batch=STEP_BATCH, vocab=vocab, seed=STEP_SEED))
    try:
        return [next(pipe) for _ in range(STEP_N)]
    finally:
        pipe.close()


def _step(grad_accum):
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.data import pipeline
    from repro.launch import steps
    from repro.models import registry as jreg
    from repro.optim import AdamWConfig, adamw_init, cosine_schedule

    cfg = configs.get_arch(STEP_ARCH, smoke=True)
    params = _params(jax, jreg, cfg)
    opt = adamw_init(params)
    ocfg = AdamWConfig(schedule=cosine_schedule(1, STEP_N), **STEP_OPT)
    fn = jax.jit(steps.make_train_step(cfg, None, ocfg, grad_accum=grad_accum,
                                       q_block=STEP_Q_BLOCK))
    out = {"params0": params, "metrics": []}
    p, o = params, opt
    for b in step_batches(pipeline, cfg.vocab):
        p, o, met = fn(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        out["metrics"].append({k: float(v) for k, v in met.items()})
    out["params"] = jax.device_get(p)
    out["opt"] = [np.asarray(x) for x in jax.tree_util.tree_leaves(o)]
    return out


def _cli(ckpt_dir):
    import jax

    from repro import configs
    from repro.launch import train
    from repro.models import registry as jreg

    seen = []
    train._print_metrics = lambda step, m: seen.append((step, dict(m)))
    train.main(CLI_ARGV + ["--checkpoint-dir", ckpt_dir])
    cfg = configs.get_arch("smollm-360m", smoke=True)
    return {"params0": _params(jax, jreg, cfg), "metrics": seen}


def run(path: Path, jobs) -> dict:
    """The jobs' results, computed in one child process with XLA's excess
    precision and algebraic simplifier off, pickled at `path` and loaded
    back."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
                        + " --xla_disable_hlo_passes=algsimp").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-m", "tests.train_reference", str(path), *jobs],
                          cwd=ROOT, env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"tests.train_reference exited {proc.returncode}")
    with open(path, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_allow_excess_precision=false" not in flags or "algsimp" not in flags:
        sys.exit("run through tests.train_reference.run: XLA_FLAGS must turn excess "
                 "precision and the algebraic simplifier off")
    out = {}
    for job in sys.argv[2:]:
        kind, _, arg = job.partition(":")
        if kind == "loss":
            out[job] = _loss(arg)
        elif kind == "step":
            out[job] = _step(int(arg))
        elif kind == "cli":
            out[job] = _cli(str(Path(sys.argv[1]).with_suffix(".ckpt")))
        else:
            sys.exit(f"unknown job {job!r}")
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
