"""The JAX package's training runs that the port's training tests
(`tests/test_torch_train_*.py`) hold it to, computed in a child process.

Jobs:
  * `loss:<arch>` — the smoke config's seeded parameters (qwen2-7b with
    random QKV biases), one batch from a numpy seed (`loss_batch`: f32
    source frames for the encoder-decoder, f32 frontend embeddings before
    a shorter text for a frontend arch), and
    `jax.value_and_grad(registry.loss_fn)` op by op: the loss, its metrics
    and every gradient leaf in flatten order;
  * `loss_fan_in:<arch>` — the same at `_fan_in` of the same draws;
  * `vjp:<layer>` — one layer of a smoke config (`VJP_CASES`: the MoE FFN,
    MLA, the SSD mixer, Jamba's hybrid group, a one-layer encoder, a
    decoder layer) at `_fan_in` of its draws, on seeded bf16 activations
    (f32 frames and encoder memory), through `jax.vjp` with a seeded
    cotangent per output: the outputs and the gradients of the layer's
    parameters and inputs in flatten order;
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

`run` may split the jobs over child processes that run at once: XLA
compiles each job's programs for seconds to a minute (Jamba's loss, ~60
s), and a test file should stay near a minute.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LOSS_ARCHS = ("yi-6b", "qwen2-7b", "smollm-360m")
FAMILY_ARCHS = ("deepseek-v2-lite-16b", "deepseek-moe-16b", "mamba2-2.7b", "jamba-v0.1-52b",
                "seamless-m4t-medium", "llava-next-34b")
LOSS_BATCH, LOSS_LEN = 2, 64
# vjp:<layer> -> the smoke config it is taken from
VJP_CASES = {"moe": "deepseek-v2-lite-16b", "mla": "deepseek-v2-lite-16b",
             "ssm": "mamba2-2.7b", "jamba_group": "jamba-v0.1-52b",
             "encoder": "seamless-m4t-medium", "decoder": "seamless-m4t-medium"}
VJP_Q_BLOCK = 16
STEP_ARCH, STEP_SEQ, STEP_BATCH, STEP_SEED, STEP_Q_BLOCK, STEP_N = "smollm-360m", 32, 4, 1, 16, 3
STEP_OPT = dict(lr=1e-3, grad_clip=1.0)   # plus cosine_schedule(1, STEP_N)
CLI_ARGV = ["--arch", "smollm-360m", "--smoke", "--steps", "20", "--batch", "4",
            "--seq-len", "32"]


def loss_batch(cfg) -> dict:
    """A training batch of LOSS_BATCH x LOSS_LEN positions from a numpy seed,
    as the pipeline shapes it: the encoder-decoder's f32 source frames
    (LOSS_LEN of them) under its tokens; a frontend arch's f32 embeddings
    before LOSS_LEN - n_frontend text tokens."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (LOSS_BATCH, LOSS_LEN + 1)).astype(np.int32)
    n_text = LOSS_LEN - (cfg.n_frontend_tokens if cfg.frontend != "none" else 0)
    batch = {"tokens": toks[:, :n_text], "labels": toks[:, 1:n_text + 1]}
    if cfg.encdec or cfg.frontend != "none":
        n_emb = LOSS_LEN if cfg.encdec else cfg.n_frontend_tokens
        batch["frontend_embeds"] = rng.standard_normal(
            (LOSS_BATCH, n_emb, cfg.d_model)).astype(np.float32)
    return batch


def _params(jax, jreg, cfg, seed=0):
    from tests.configs_reference import with_random_bias
    with jax.threefry_partitionable(True):
        params = jax.device_get(jreg.materialize_params(cfg, seed))
    return with_random_bias(params) if cfg.qkv_bias else params


def _fan_in(jax, params, arch):
    """The reference's draws at the port's `common.fan_in_init` (std 1 /
    sqrt(fan-in) for every layer weight), which leaves the bf16 gradients
    meaningful where the reference's init makes them rounding noise."""
    import ml_dtypes
    import torch

    from repro_torch import configs as tconfigs
    from repro_torch import convert, tree
    from repro_torch.models import common as tcommon

    scaled = tcommon.fan_in_init(convert.from_jax_params(
        params, tconfigs.get_arch(arch, smoke=True), device="cpu"))
    leaves = [t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
              if t.dtype == torch.bfloat16 else t.numpy() for t in tree.leaves(scaled)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), leaves)


def _loss(arch, fan_in=False):
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.models import registry as jreg

    cfg = configs.get_arch(arch, smoke=True)
    params = _params(jax, jreg, cfg)
    if fan_in:
        params = _fan_in(jax, params, arch)
    batch = loss_batch(cfg)
    # op by op: jitted whole, XLA's fusions round one bf16 logit of
    # smollm's batch otherwise than the op-by-op run (and the port) do
    fn = jax.value_and_grad(lambda p, b: jreg.loss_fn(p, b, cfg), has_aux=True)
    (loss, met), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"params": params, "batch": batch, "loss": float(loss),
            "metrics": {k: float(v) for k, v in met.items()},
            "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]}


def _vjp(kind):
    import dataclasses

    import jax
    import ml_dtypes

    from repro import configs
    from repro.models import attention, blocks, encdec, mlp, ssm
    from repro.models import registry as jreg

    cfg = configs.get_arch(VJP_CASES[kind], smoke=True)
    params = _fan_in(jax, _params(jax, jreg, cfg), VJP_CASES[kind])
    rng = np.random.default_rng(21)
    shape = (LOSS_BATCH, LOSS_LEN, cfg.d_model)
    x = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    first = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a[0]), t)  # noqa: E731
    ctx = blocks.RunCtx(q_block=VJP_Q_BLOCK)
    inputs = [x]
    if kind == "moe":
        p = first(params["groups"])["sub0"]["moe"]
        fn = lambda p, x: tuple(mlp.moe_ffn(p, x, cfg))                      # noqa: E731
    elif kind == "mla":
        p = params["prefix"]["layer0"]["attn"]
        fn = lambda p, x: (attention.mla_forward(p, x, cfg, q_block=VJP_Q_BLOCK)[0],)  # noqa: E731
    elif kind == "ssm":
        p = first(params["groups"])["sub0"]["ssm"]
        fn = lambda p, x: (ssm.ssm_forward(p, x, cfg)[0],)                   # noqa: E731
    elif kind == "jamba_group":
        p = first(params["groups"])
        fn = lambda p, x: blocks.apply_group_full(p, x, cfg, ctx, False)[::2]  # noqa: E731
    elif kind == "encoder":
        cfg = dataclasses.replace(cfg, n_enc_layers=1)
        p = {"audio_proj": params["audio_proj"], "enc_norm": params["enc_norm"],
             "enc_layers": jax.tree_util.tree_map(lambda a: np.asarray(a[:1]),
                                                  params["enc_layers"])}
        inputs = [rng.standard_normal(shape).astype(np.float32)]
        fn = lambda p, x: (encdec.encode(p, x, cfg, ctx),)                    # noqa: E731
    elif kind == "decoder":
        p = first(params["dec_layers"])
        inputs = [x, rng.standard_normal(shape).astype(np.float32)]
        fn = lambda p, x, enc: (encdec._dec_layer_full(p, x, enc, cfg, ctx, False, None)[0],)  # noqa: E731
    else:
        raise ValueError(kind)
    outs, vjp = jax.vjp(fn, p, *inputs)
    cts = [np.asarray(rng.standard_normal(o.shape)).astype(o.dtype) for o in outs]
    grads = vjp(tuple(cts))
    return {"params": jax.device_get(p), "inputs": inputs, "outs": [np.asarray(o) for o in outs],
            "cts": cts, "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]}


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


def run(path: Path, jobs, *more) -> dict:
    """The jobs' results, computed with XLA's excess precision and algebraic
    simplifier off, pickled beside `path` and loaded back: `jobs` in one
    child process, each further list of jobs in another, all at once."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
                        + " --xla_disable_hlo_passes=algsimp").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    paths = [path.with_name(f"{path.stem}_{i}{path.suffix}") if more else path
             for i in range(1 + len(more))]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.train_reference", str(p), *group],
                              cwd=ROOT, env=env) for p, group in zip(paths, (jobs, *more))]
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=600))
        finally:
            if proc.poll() is None:
                proc.kill()
    if any(codes):
        raise RuntimeError(f"tests.train_reference exited {codes}")
    out = {}
    for p in paths:
        with open(p, "rb") as f:
            out.update(pickle.load(f))
    return out


if __name__ == "__main__":
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_allow_excess_precision=false" not in flags or "algsimp" not in flags:
        sys.exit("run through tests.train_reference.run: XLA_FLAGS must turn excess "
                 "precision and the algebraic simplifier off")
    out = {}
    for job in sys.argv[2:]:
        kind, _, arg = job.partition(":")
        if kind in ("loss", "loss_fan_in"):
            out[job] = _loss(arg, fan_in=kind == "loss_fan_in")
        elif kind == "step":
            out[job] = _step(int(arg))
        elif kind == "vjp":
            out[job] = _vjp(arg)
        elif kind == "cli":
            out[job] = _cli(str(Path(sys.argv[1]).with_suffix(".ckpt")))
        else:
            sys.exit(f"unknown job {job!r}")
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
