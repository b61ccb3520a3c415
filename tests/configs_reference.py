"""The JAX engines' runs that `tests/test_torch_configs.py` holds the port to:
the smoke configs of zipcache-paper-8b, deepseek-moe-16b, qwen2-7b, yi-34b
and smollm-360m, and a g = 7 variant of qwen2-7b's (7 query heads over one
kv head, head dim 16), each on the lockstep and the continuous engine, with
its parameters, prefill logits and cache bytes.

qwen2's QKV biases are zeros at initialization; here they are drawn from a
seeded normal before any run, so that the bias reaches the prefill and
every decode step.  The continuous engine runs on the paged free list; the
reference refuses MoE archs there, so deepseek-moe-16b's engine is built
with that check hidden (as `tests/hybrid_reference.py` does for Jamba).

For deepseek-moe-16b it also keeps layer 0's attention output and the
output of that dense prefix layer, before any router.

The runs are jitted with XLA's excess precision off
(`--xla_allow_excess_precision=false`) and its algebraic simplifier off
(`--xla_disable_hlo_passes=algsimp`), both read once per process: each bf16
operation then rounds on its own, and the f32 sums over heads (the probe
column sums, which decide the salient split) run in the op-by-op order, so
the jitted runs give the op-by-op run's tokens, as the port does.  With the
simplifier on, g = 7 (and qwen2's biased smoke) take other tokens at a
near tie.  They run in child processes (`run`), the archs split over two of
them; smoke configs that differ only in their name run once.

    python -m tests.configs_reference OUT.pkl ARCH [ARCH ...]   (run() sets the flags)
"""

import builtins
import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PAPER, DSMOE, QWEN, YI34, SMOL = ("zipcache-paper-8b", "deepseek-moe-16b", "qwen2-7b", "yi-34b",
                                  "smollm-360m")
G7 = "qwen2-7b-g7"          # qwen2-7b's smoke config at 7 / 1 heads, head dim 16
ARCHS = (PAPER, DSMOE, QWEN, YI34, SMOL, G7)
BATCH, PROMPT, MAX_NEW = 2, 32, 12
CONT_LENGTHS = (32, 20, 27)
CONT_NEW = 10
PAGE = 8
FREELIST = dict(backend="paged", page_size=PAGE, page_allocator="freelist", pool_fraction=0.75)
BIAS_KEYS = ("bq", "bk", "bv")


def smoke(configs, arch):
    """The smoke config of `arch`, or the g = 7 variant, from either
    package's registry."""
    if arch == G7:
        cfg = configs.get_arch(QWEN, smoke=True)
        return dataclasses.replace(cfg, name="qwen2-7b-g7-smoke", n_heads=7, n_kv_heads=1,
                                   d_model=112)
    return configs.get_arch(arch, smoke=True)


def batch(vocab):
    rng = np.random.default_rng(0)
    out = np.zeros((BATCH, PROMPT), np.int32)
    for i, n in enumerate((PROMPT, PROMPT - 9)):   # row 1 left-padded
        out[i, PROMPT - n:] = rng.integers(2, vocab, size=(n,))
    return {"tokens": out}


def prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(2, vocab, size=(n,)).astype(np.int32) for n in CONT_LENGTHS]


def scenario(eng, request, ps):
    """Two slots; a short request retires after 3 tokens and a third,
    submitted mid-run, takes its slot."""
    r0 = eng.submit(request(tokens=ps[0]))
    r1 = eng.submit(request(tokens=ps[1], max_new_tokens=3))
    eng.step()
    r2 = eng.submit(request(tokens=ps[2]))
    res = eng.run()
    return [(res[r].tokens.tolist(), res[r].finish_reason) for r in (r0, r1, r2)]


def with_random_bias(params, seed=7):
    """Every attention layer's bq / bk / bv drawn from a seeded normal (x 0.5)
    in the leaf's dtype; a numpy tree in, a numpy tree out."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.normal(size=np.shape(v)).astype(np.float32) * 0.5).astype(v.dtype)
                    if k in BIAS_KEYS else walk(v) for k, v in node.items()}
        return node

    return walk(params)


def _reference(arch):
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import backend as jbackend
    from repro.core.policy import CompressionConfig
    from repro.models import attention as jattention
    from repro.models import blocks as jblocks
    from repro.models import common as jcommon
    from repro.models import lm as jlm
    from repro.models import registry as jregistry
    from repro.serving import ContinuousEngine, Request, ServeConfig, ServingEngine
    from repro.serving import engine as jengine

    @contextlib.contextmanager
    def moe_admitted():
        """Hide `n_experts` from the EngineCore's MoE check (its only
        `getattr` of that name) while a ContinuousEngine is built."""
        def shim(obj, name, *default):
            return 0 if name == "n_experts" else builtins.getattr(obj, name, *default)

        jengine.getattr = shim
        try:
            yield
        finally:
            del jengine.getattr

    cfg = smoke(jconfigs, arch)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    with jax.threefry_partitionable(True):
        params = jax.device_get(jregistry.materialize_params(cfg, seed=0))
    if cfg.qkv_bias:
        params = with_random_bias(params)
    b = batch(cfg.vocab)
    out = {"batch": b, "params": params, "param_count": cfg.param_count()}
    eng = ServingEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, MAX_NEW), params)
    prefill = jax.jit(lambda p, t: jregistry.prefill(p, {"tokens": t}, cfg, eng.ctx)[0])
    out["logits"] = np.asarray(prefill(params, jnp.asarray(b["tokens"])).astype(jnp.float32))
    if cfg.first_dense_layers:   # the dense prefix layer, before any router
        def layer0(p0, toks):
            x = jlm.embed_inputs(params, cfg, toks)
            h = jcommon.rms_norm(x, p0["ln1"], cfg.norm_eps)
            y, _ = jattention.gqa_forward(p0["attn"], h, cfg, probe=eng.ctx.probe,
                                          q_block=eng.ctx.q_block, use_kernel=False)
            x1, _, _ = jblocks.apply_layer_full(p0, x, cfg, "attn", "dense", eng.ctx,
                                                build_cache=False)
            return y, x1

        y, x1 = jax.jit(layer0)(params["prefix"]["layer0"], jnp.asarray(b["tokens"]))
        out["layer0_attn"], out["prefix_out"] = np.asarray(y), np.asarray(x1)
    out["lockstep"] = eng.generate(b)["tokens"]
    out["lockstep_bytes"] = eng.cache_bytes(eng.last_caches)
    with moe_admitted():
        ceng = ContinuousEngine(cfg, ccfg, ServeConfig(
            batch_size=BATCH, prompt_len=PROMPT, max_new_tokens=CONT_NEW, **FREELIST), params)
    out["continuous"] = scenario(ceng, Request, prompts(cfg.vocab))
    out["continuous_bytes"] = jbackend.cache_bytes(ceng.caches)
    return out


def run(path: Path) -> dict:
    """The references, computed in two child processes at once with XLA's
    excess precision and algebraic simplifier off, pickled beside `path` and
    loaded back."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
                        + " --xla_disable_hlo_passes=algsimp").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    halves = ((PAPER, YI34, DSMOE), (QWEN, G7, SMOL))
    parts = [path.with_name(f"{path.stem}.{i}{path.suffix}") for i in range(len(halves))]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.configs_reference", str(p), *archs],
                              cwd=ROOT, env=env) for p, archs in zip(parts, halves)]
    try:
        for proc in procs:
            if proc.wait(timeout=900) != 0:
                raise RuntimeError(f"tests.configs_reference exited {proc.returncode}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    refs = {}
    for p in parts:
        with open(p, "rb") as f:
            refs.update(pickle.load(f))
    return refs


if __name__ == "__main__":
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_allow_excess_precision=false" not in flags or "algsimp" not in flags:
        sys.exit("run through tests.configs_reference.run: XLA_FLAGS must turn excess "
                 "precision and the algebraic simplifier off")
    from repro import configs as jconfigs

    refs, runs = {}, {}
    for arch in sys.argv[2:]:
        # smoke configs equal but for their name (yi-34b's and
        # zipcache-paper-8b's) run the same computation: once
        key = dataclasses.replace(smoke(jconfigs, arch), name="")
        refs[arch] = runs[key] if key in runs else runs.setdefault(key, _reference(arch))
    with open(sys.argv[1], "wb") as f:
        pickle.dump(refs, f)
