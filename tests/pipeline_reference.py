"""The JAX package's pipeline (`repro.launch.pipeline`) that
`tests/test_torch_pipeline_jax.py` holds the port's to, computed in one
child process on 8 fake CPU devices, with XLA's excess precision and
algebraic simplifier off (every bf16 operation rounds on its own, as the
port's do) and a persistent compilation cache beside the pickle.

The reference's `pp_forward` calls `jax.experimental.shard_map.shard_map`
with an `auto=` keyword, which this image's JAX no longer takes (its
`jax.shard_map` has `axis_names=` and `check_vma=` instead): that is why
`tests/test_pipeline.py` fails at setup here.  `install_shard_map_shim`
puts a translation in its place before `repro.launch.pipeline` is
imported, in this child process only; nothing of the JAX package is
edited.  With it the reference runs on a stage-only mesh.  Its mixed
stage x data x model mesh still aborts XLA:CPU (the reference's own
`make_pp_mesh` docstring), so the port holds that mesh to its own
one-process step instead (`tests/test_torch_pipeline.py`).

Every job is `tests/test_pipeline.py`'s scenario: the smoke config, a
batch of 8 x 64 from `materialize_batch(..., 0, vocab)`, 4 microbatches,
q_block 32; `pp_forward`'s logits against `lm.forward(remat=False)`'s, then
3 steps of `make_pp_train_step` jitted with `pp_lowering_inputs`'
shardings:

  * `yi2` -- yi-6b at 2 stages;
  * `yi4` -- yi-6b with `n_layers=4` at 4 stages (the smoke config's 2
    groups do not split over 4: the reference asserts);
  * `smol2` -- smollm-360m (tied embeddings) at 2 stages.

A job's parameters come from the caller (`inputs`, in IN.pkl, so that the
port's ranks can start from them at once): `materialize_params(cfg, 0)`,
as the reference test draws them, and for `<job>@fan_in` the same draws at
the port's `common.fan_in_init`.  At the reference's init the bf16
gradients are rounding noise (ROADMAP.md §3), so the grad norms of a
second and third step differ from one rounding order to another by
percents; at the fan-in one they do not.

Each result: both forwards' logits (uint16 words), and the pipelined
steps' losses, grad norms, metric names and the parameters after the 3
steps (numpy f32, flatten order).

    python -m tests.pipeline_reference OUT.pkl IN.pkl JOB [JOB ...]   (run() sets the flags)
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, MICRO, Q_BLOCK, STEPS = 8, 64, 4, 32, 3
JOBS = {"yi2": ("yi-6b", None, 2), "yi4": ("yi-6b", 4, 4), "smol2": ("smollm-360m", None, 2)}


def install_shard_map_shim():
    """`jax.experimental.shard_map.shard_map(f, mesh, in_specs, out_specs,
    check_rep, auto)` as the reference calls it, over this JAX's
    `jax.shard_map`: the manual axes are the mesh's axes less `auto`."""
    import jax
    import jax.experimental.shard_map as sm

    def shard_map(f, mesh, in_specs, out_specs, check_rep=True, auto=frozenset()):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             axis_names=frozenset(mesh.axis_names) - frozenset(auto),
                             check_vma=check_rep)

    sm.shard_map = shard_map


def cfg_of(configs, arch, n_layers):
    import dataclasses
    cfg = configs.get_arch(arch, smoke=True)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def inputs(jobs) -> dict:
    """{job: {"params": leaves in flatten order (bf16 as uint16 words),
    "batch": numpy}} of the jobs, drawn in this process by the JAX
    package."""
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.configs.base import ShapeConfig
    from repro.models import registry

    out = {}
    for job in jobs:
        name, _, init = job.partition("@")
        arch, n_layers, _ = JOBS[name]
        cfg = cfg_of(configs, arch, n_layers)
        leaves = [_words(x) for x in jax.tree_util.tree_leaves(
            registry.materialize_params(cfg, 0))]
        if init == "fan_in":
            leaves = _fan_in(arch, n_layers, leaves)
        batch = registry.materialize_batch(
            registry.train_batch_spec(cfg, ShapeConfig("t", SEQ, BATCH, "train"), jnp.float32),
            0, cfg.vocab)
        out[job] = {"params": leaves, "batch": {k: np.asarray(v) for k, v in batch.items()}}
    return out


def to_port(leaves, like):
    """Flatten-order leaves (bf16 as uint16 words) -> the port's tree shaped
    as `like`."""
    import torch
    from repro_torch import tree
    return tree.unflatten(like, [torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
                                 if a.dtype == np.uint16 else torch.from_numpy(a.copy())
                                 for a in leaves])


def _fan_in(arch, n_layers, leaves):
    """The leaves at the port's `common.fan_in_init`."""
    import torch
    from repro_torch import configs, tree
    from repro_torch.models import common, registry

    like = registry.materialize_params(cfg_of(configs, arch, n_layers), 0, device="cpu")
    scaled = common.fan_in_init(to_port(leaves, like))
    return [x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
            else x.numpy() for x in tree.leaves(scaled)]


def _words(x):
    import jax.numpy as jnp
    return np.asarray(x).view(np.uint16) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _job(job, inp):
    install_shard_map_shim()
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.configs.base import ShapeConfig
    from repro.launch import pipeline as pp
    from repro.models import blocks, lm, registry
    from repro.optim import adamw

    arch, n_layers, stages = JOBS[job.partition("@")[0]]
    cfg = cfg_of(configs, arch, n_layers)
    mesh = pp.make_pp_mesh(stages=stages, data=1, model=1)
    shp = ShapeConfig("t", SEQ, BATCH, "train")
    like = registry.abstract_params(cfg)
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like),
        [jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16 else a)
         for a in inp["params"]])
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    with mesh:
        ctx = blocks.RunCtx(q_block=Q_BLOCK)
        logits_pp = jax.jit(lambda p, t: pp.pp_forward(p, t, cfg, mesh, microbatches=MICRO,
                                                       ctx=ctx))(params, batch["tokens"])
    logits = jax.jit(lambda p, t: lm.forward(p, t, cfg, remat=False).logits)(
        params, batch["tokens"])
    step = pp.make_pp_train_step(cfg, mesh, microbatches=MICRO, q_block=Q_BLOCK)
    _, in_sh, out_sh = pp.pp_lowering_inputs(cfg, shp, mesh)
    losses, norms = [], []
    with mesh:
        fn = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)
        p, opt = params, adamw.adamw_init(params)
        for _ in range(STEPS):
            p, opt, met = fn(p, opt, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    return {"pp_logits": _words(logits_pp), "logits": _words(logits), "losses": losses,
            "grad_norms": norms, "metric_keys": sorted(met),
            "params": [np.asarray(x.astype(jnp.float32)) for x in jax.tree_util.tree_leaves(p)]}


def run(path: Path, in_path: Path, jobs) -> dict:
    """The jobs' results from one child process on 8 fake devices, their
    inputs in in_path (`inputs`)."""
    env = dict(os.environ)
    env["JAX_COMPILATION_CACHE_DIR"] = str(path.with_name(f"{path.stem}.jaxcache"))
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "0"
    # a collective's fake devices are threads: on a loaded machine one can
    # reach the rendezvous later than XLA's 40 s default, which aborts
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
                        + " --xla_allow_excess_precision=false"
                        + " --xla_disable_hlo_passes=algsimp"
                        + " --xla_cpu_collective_call_terminate_timeout_seconds=600").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen([sys.executable, "-m", "tests.pipeline_reference", str(path),
                             str(in_path), *jobs], cwd=ROOT, env=env)
    try:
        if proc.wait(timeout=600) != 0:
            raise RuntimeError(f"tests.pipeline_reference exited {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(path, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    if "device_count=8" not in os.environ.get("XLA_FLAGS", ""):
        sys.exit("run through tests.pipeline_reference.run: XLA_FLAGS must give 8 fake devices")
    with open(sys.argv[2], "rb") as f:
        given = pickle.load(f)
    res = {job: _job(job, given[job]) for job in sys.argv[3:]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
