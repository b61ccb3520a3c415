"""The JAX package's training on a mesh that `tests/test_torch_mesh_moe.py`
holds the port to, computed in one child process on 8 fake CPU devices
(`--xla_force_host_platform_device_count=8`), with XLA's excess precision
and algebraic simplifier off (every bf16 operation rounds on its own, as
the port's do) and a persistent compilation cache beside the pickle.

Jobs:
  * `moe` -- one MoE layer of DeepSeek-V2-Lite's smoke config on a 4 x 2
    ("data", "model") mesh: seeded bf16 tokens (MOE_B x MOE_S) and
    weights (the router f32), `models.mlp.moe_ffn(..., mesh=)`: the inputs,
    the output, the reference's capacity (its rule over the local token
    count) and the router's top-k expert ids (for the drops);
  * `ds_step` -- the reference test's own case (`tests/test_sharding.py`):
    DeepSeek-V2-Lite smoke, seq 64, batch 8, `make_train_step(cfg, mesh,
    grad_accum=2, q_block=32)` jitted with `train_lowering_inputs`'
    shardings, 3 steps from `materialize_params(cfg, 0)` and
    `materialize_batch(..., 0, vocab)`: the parameters (bf16 as uint16)
    and batch it started from, and its losses;
  * `ds_step_f32` -- the same case from the same parameters cast to f32,
    one step (computed in f32; AdamW hands the parameters back in bf16):
    its loss and metrics, and the parameters, master, m, v and count after
    it (numpy f32, in flatten order).

  * `serve_yi` -- the JAX lockstep engine on the 4 x 2 mesh and without
    one: yi-6b smoke, zipcache at fp_window = recompress_interval = 8,
    `ServeConfig(batch_size=4, prompt_len=24, max_new_tokens=12)`,
    `materialize_params(cfg, 0)`, prompts from `default_rng(0).integers(2,
    vocab, (24,))`: its tokens and logits (the prefill's, then every
    step's, f32);
  * `serve_ds` -- `tests/test_sharding.py`'s decode step on
    DeepSeek-V2-Lite smoke: `make_serve_step(cfg, ShapeConfig("d", 128, 8,
    "decode"), mesh, zipcache, q_block=32)` jitted with
    `decode_lowering_inputs`' shardings, from `materialize_params(cfg, 0)`
    over empty caches, tokens 0 and a probe step: its logits.

    python -m tests.mesh_reference OUT.pkl JOB [JOB ...]   (run() sets the flags)
"""

import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MOE_B, MOE_S = 8, 16


def moe_inputs(cfg) -> dict:
    """Seeded numpy inputs of one MoE layer (bf16 leaves as uint16 words)."""
    import ml_dtypes
    rng = np.random.default_rng(5)
    e, f, n = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    fs = cfg.n_shared_experts * cfg.moe_d_ff
    bf = lambda a: a.astype(ml_dtypes.bfloat16).view(np.uint16)
    router = rng.standard_normal((e, n)) * 0.5
    router[:, 0] += 0.2          # with the tokens' mean, expert 0 is over capacity: drops
    return {"x": bf(rng.standard_normal((MOE_B, MOE_S, e)) + 0.5),
            "router": router.astype(np.float32),
            "w_gate": bf(rng.standard_normal((n, e, f)) / math.sqrt(e)),
            "w_up": bf(rng.standard_normal((n, e, f)) / math.sqrt(e)),
            "w_down": bf(rng.standard_normal((n, f, e)) / math.sqrt(f)),
            "shared": {"w_gate": bf(rng.standard_normal((e, fs)) / math.sqrt(e)),
                       "w_up": bf(rng.standard_normal((e, fs)) / math.sqrt(e)),
                       "w_down": bf(rng.standard_normal((fs, e)) / math.sqrt(fs))}}


def _mesh(jax, shape, axes):
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:math.prod(shape)]).reshape(shape), axes)


def _moe():
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.models import mlp

    cfg = configs.get_arch("deepseek-v2-lite-16b", smoke=True)
    inp = moe_inputs(cfg)
    bf = lambda a: jnp.asarray(a.view(jnp.bfloat16))
    params = {"router": jnp.asarray(inp["router"]),
              **{k: bf(inp[k]) for k in ("w_gate", "w_up", "w_down")},
              "shared": {k: bf(v) for k, v in inp["shared"].items()}}
    mesh = _mesh(jax, (4, 2), ("data", "model"))
    with mesh:
        out = mlp.moe_ffn(params, bf(inp["x"]), cfg, mesh=mesh, data_axes=("data",))
    probs = jax.nn.softmax(jnp.einsum("bse,en->bsn", bf(inp["x"]).astype(jnp.float32),
                                      params["router"]), axis=-1)
    _, eidx = jax.lax.top_k(probs, cfg.top_k)
    n_local = (MOE_B // 4) * MOE_S          # the reference's rule: tokens over data
    cap = max(1, int(math.ceil(n_local * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))
    return {"inputs": inp, "y": np.asarray(out.y).view(np.uint16), "capacity": cap,
            "eidx": np.asarray(eidx)}


def _ds_step(f32: bool = False):
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.configs.base import ShapeConfig
    from repro.launch import steps as S
    from repro.models import registry
    from repro.optim import adamw

    cfg = configs.get_arch("deepseek-v2-lite-16b", smoke=True)
    shp = ShapeConfig("t", 64, 8, "train")
    mesh = _mesh(jax, (4, 2), ("data", "model"))
    fn = S.make_train_step(cfg, mesh, grad_accum=2, q_block=32)
    args, in_sh, out_sh = S.train_lowering_inputs(cfg, shp, mesh)
    params = registry.materialize_params(cfg, 0)
    if f32:
        params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    batch = registry.materialize_batch(registry.train_batch_spec(cfg, shp, jnp.float32), 0,
                                       cfg.vocab)
    names = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(params)]
    start = {"params": [np.asarray(x).view(np.uint16) if x.dtype == jnp.bfloat16
                        else np.asarray(x) for x in jax.tree_util.tree_leaves(params)],
             "names": names, "batch": {k: np.asarray(v) for k, v in batch.items()}}
    with mesh:
        step = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        opt = adamw.adamw_init(params)
        losses = []
        for _ in range(1 if f32 else 3):
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))
    if not f32:
        return {**start, "losses": losses}
    state = [np.asarray(x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x)
             for x in jax.tree_util.tree_leaves((params, opt))]
    return {"metrics": {k: float(v) for k, v in met.items()}, "state": state}


SERVE_B, SERVE_PROMPT, SERVE_NEW = 4, 24, 12


def serve_params(arch: str):
    """`materialize_params(smoke cfg, 0)` of the JAX package as numpy, bf16
    leaves as uint16 words (what `_serve_yi` / `_serve_ds` draw)."""
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.models import registry
    with jax.threefry_partitionable(True):
        params = registry.materialize_params(configs.get_arch(arch, smoke=True), 0)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x).view(np.uint16) if x.dtype == jnp.bfloat16 else np.asarray(x),
        params)


def _serve_yi():
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.core.policy import CompressionConfig
    from repro.models import registry
    from repro.serving.engine import ServeConfig, ServingEngine, pack_requests

    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    scfg = ServeConfig(batch_size=SERVE_B, prompt_len=SERVE_PROMPT, max_new_tokens=SERVE_NEW)
    params = registry.materialize_params(cfg, 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, (SERVE_PROMPT,)).astype(np.int32)
               for _ in range(SERVE_B)]
    batch = {"tokens": pack_requests(prompts, SERVE_B, SERVE_PROMPT)}
    mesh = _mesh(jax, (4, 2), ("data", "model"))
    logits = []

    def recorded(fn):
        def run(*a):
            out = fn(*a)
            logits.append(np.asarray(out[0].astype(jnp.float32)))
            return out
        return run

    with mesh:
        eng = ServingEngine(cfg, ccfg, scfg, params, mesh=mesh)
        eng._prefill, eng._decode = recorded(eng._prefill), recorded(eng._decode)
        tokens = np.asarray(eng.generate(batch)["tokens"])
    return {"tokens": tokens, "logits": np.stack(logits)}


def _serve_ds():
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.configs.base import ShapeConfig
    from repro.core.policy import CompressionConfig
    from repro.launch import steps as S
    from repro.models import registry

    cfg = configs.get_arch("deepseek-v2-lite-16b", smoke=True)
    mesh = _mesh(jax, (4, 2), ("data", "model"))
    shp = ShapeConfig("d", 128, 8, "decode")
    fn, ctx = S.make_serve_step(cfg, shp, mesh, CompressionConfig.zipcache(), q_block=32)
    args, in_sh, out_sh = S.decode_lowering_inputs(cfg, shp, mesh, ctx)
    params = registry.materialize_params(cfg, 0)
    with mesh:
        step = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        caches = registry.init_caches(cfg, ctx, 8)
        logits, _ = step(jax.device_put(params, in_sh[0]), caches, jnp.zeros((8,), jnp.int32),
                         jnp.asarray(True))
    return {"logits": np.asarray(logits.astype(jnp.float32))}


def run(path: Path, jobs) -> dict:
    """The jobs' results from one child process on 8 fake devices."""
    env = dict(os.environ)
    env["JAX_COMPILATION_CACHE_DIR"] = str(path.with_name(f"{path.stem}.jaxcache"))
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "0"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
                        + " --xla_allow_excess_precision=false"
                        + " --xla_disable_hlo_passes=algsimp").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen([sys.executable, "-m", "tests.mesh_reference", str(path), *jobs],
                            cwd=ROOT, env=env)
    try:
        if proc.wait(timeout=900) != 0:
            raise RuntimeError(f"tests.mesh_reference exited {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(path, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    if "device_count=8" not in os.environ.get("XLA_FLAGS", ""):
        sys.exit("run through tests.mesh_reference.run: XLA_FLAGS must give 8 fake devices")
    out = {"moe": _moe, "ds_step": _ds_step, "ds_step_f32": lambda: _ds_step(f32=True),
           "serve_yi": _serve_yi, "serve_ds": _serve_ds}
    res = {job: out[job]() for job in sys.argv[2:]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
