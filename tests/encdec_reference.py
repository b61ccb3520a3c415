"""The JAX package's runs that `tests/test_torch_encdec.py` (part
"functions") and `tests/test_torch_encdec_engine.py` (parts "seamless-long"
and "llava") hold the port to: seamless-m4t-medium (encoder-decoder) and llava-next-34b
(vision frontend) smoke, function by function and on the lockstep engine.

Each part runs op by op (`jax.disable_jit()`) in a child process (`run`),
each operation rounding on its own as in the port.  Jitted, even with XLA's
excess precision off (`tests/hybrid_reference.py`), the CPU compiler's
algebraic rewrites move the last bits: the greedy tokens of both models
then differ from the op-by-op run's at a near tie, and a 2-bit zero point
flips in seamless's first self cache.  Most of each run is per-operation
compiles, shared by the runs of one part.

    python -m tests.encdec_reference functions|seamless-long|llava OUT.pkl
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEAMLESS, LLAVA = "seamless-m4t-medium", "llava-next-34b"
BATCH, MAX_NEW = 2, 12
PREFILL_LEN = 64       # source frames = decoder prompt (test_serve_path_smoke's shape)
LONG_PROMPT = 256      # source frames past 128: the decoder prompt is min(128, l)
DECODE_PROBES = (True, False, True)
# the attention and encoder inputs take the prefill's shapes: op by op, the
# prefill then reuses their compiled operations
ATTN_Q = ATTN_KV = ENCODE_LEN = ATTN_Q_BLOCK = PREFILL_LEN


def ccfg_kwargs():
    """The conformance cadence: a probe step and a fold within MAX_NEW."""
    return dict(fp_window=8, recompress_interval=8)


def engine_inputs(cfg, prompt_len, dec_len):
    """The serve CLI's inputs for `prompt_len`: seeded prompts, then f32
    frontend embeddings from the same generator; the text cut to `dec_len`
    tokens (the encoder-decoder's decoder prompt, a frontend arch's text)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=(prompt_len,)).astype(np.int32)
               for _ in range(BATCH)]
    tokens = np.stack(prompts)
    n = prompt_len if cfg.encdec else cfg.n_frontend_tokens
    embeds = rng.standard_normal((BATCH, n, cfg.d_model)).astype(np.float32)
    return {"tokens": tokens[:, :dec_len], "frontend_embeds": embeds}


def long_inputs(cfg):
    """The engine inputs at LONG_PROMPT source frames, the frames in bf16
    (`tests/test_torch_encdec_engine.py` says why)."""
    import ml_dtypes

    inputs = engine_inputs(cfg, LONG_PROMPT, 128)
    inputs["frontend_embeds"] = inputs["frontend_embeds"].astype(ml_dtypes.bfloat16)
    return inputs


def attention_inputs():
    rng = np.random.default_rng(3)
    return {"x": rng.standard_normal((BATCH, ATTN_Q, 64)).astype(np.float32),
            "mem": rng.standard_normal((BATCH, ATTN_KV, 64)).astype(np.float32),
            "src": rng.standard_normal((BATCH, ENCODE_LEN, 64)).astype(np.float32)}


def flat(el, prefix=""):
    """{field path: array} of a cache element (a dataclass tree); the static
    fields (bits, shape) are left out."""
    out = {}
    for f in dataclasses.fields(el):
        v = getattr(el, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flat(v, f"{prefix}{f.name}."))
        elif hasattr(v, "dtype") and hasattr(v, "shape") and not isinstance(v, tuple):
            out[prefix + f.name] = v
    return out


def _layers(caches, n_layers):
    """The reference's stacked DecLayerCaches -> per layer {"self", "cross"}
    flat numpy dicts."""
    import jax
    caches = jax.device_get(caches)
    return [{"self": {k: np.asarray(v[i]) for k, v in flat(caches.self_cache).items()},
             "cross": {k: np.asarray(v[i]) for k, v in flat(caches.cross_cache).items()}}
            for i in range(n_layers)]


def _params(cfg):
    """The reference's parameters for `cfg`, drawn jitted (op by op the
    draws take seconds of compiles; the port takes these values as they
    are)."""
    import jax

    from repro.models import registry as jregistry
    with jax.threefry_partitionable(True), jax.disable_jit(False):
        return jax.device_get(jax.jit(lambda: jregistry.materialize_params(cfg, seed=0))())


def _seamless_functions():
    """gqa_forward in its three uses, the encoder, and the lockstep engine's
    prefill (f32 and bf16 frames), decode steps and fold at PREFILL_LEN."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import backend as jbackend
    from repro.core import saliency as jsal
    from repro.core.policy import CompressionConfig
    from repro.models import attention as jattn
    from repro.models import encdec as jencdec
    from repro.models import registry as jregistry
    from repro.serving import ServeConfig, ServingEngine

    cfg = jconfigs.get_arch(SEAMLESS, smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), **ccfg_kwargs())
    out = {"params": jax.device_get(_params(cfg))}
    params = jax.tree_util.tree_map(jnp.asarray, out["params"])

    # gqa_forward in its three uses, layer 0's weights
    a = attention_inputs()
    x, mem = jnp.asarray(a["x"]).astype(jnp.bfloat16), jnp.asarray(a["mem"])
    layer0 = jax.tree_util.tree_map(lambda t: t[0], params)
    uses = {
        "causal": (layer0["dec_layers"]["self_attn"], x, dict(causal=True), ATTN_Q),
        "encoder": (layer0["enc_layers"]["attn"], mem, dict(causal=False), ATTN_KV),
        "cross": (layer0["dec_layers"]["cross_attn"], x, dict(causal=False, kv_x=mem), ATTN_Q),
    }
    out["attn"] = {}
    for name, (p, inp, kw, n_probe_rows) in uses.items():
        y, aux = jattn.gqa_forward(p, inp, cfg, probe=jsal.select_probes(n_probe_rows),
                                   q_block=ATTN_Q_BLOCK, **kw)
        out["attn"][name] = jax.device_get({"y": y, "k": aux.k, "v": aux.v,
                                            "saliency": aux.saliency, "nnz": aux.probe_nnz})

    # the encoder on f32 and on bf16 frame embeddings
    src = jnp.asarray(a["src"])
    out["encode"] = {jnp.dtype(dt).name: jax.device_get(
        jencdec.encode(params, src.astype(dt), cfg, remat=False))
        for dt in (jnp.float32, jnp.bfloat16)}

    # the engine's prefill on the serve CLI's f32 frames: three decode steps
    # (probe, plain, probe), a fold and a probe step after it; then its
    # prefill on the same frames in bf16, and its greedy tokens
    eng = ServingEngine(cfg, ccfg, ServeConfig(BATCH, PREFILL_LEN, MAX_NEW), params)
    ctx = eng.ctx
    inputs = engine_inputs(cfg, PREFILL_LEN, PREFILL_LEN)
    batch = {k: jnp.asarray(v) for k, v in inputs.items()}
    logits, caches = jregistry.prefill(params, batch, cfg, ctx)
    out["prefill"] = {"inputs": inputs, "logits": jax.device_get(logits),
                      "caches": _layers(caches, cfg.n_layers),
                      "bytes": jbackend.cache_bytes(caches)}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    steps = []
    for probe in DECODE_PROBES:
        logits, caches = jregistry.decode_step(params, tok, caches, cfg, ctx, jnp.asarray(probe))
        steps.append(jax.device_get(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    folded = jregistry.recompress(caches, cfg, ctx)
    logits, _ = jregistry.decode_step(params, tok, folded, cfg, ctx, jnp.asarray(True))
    out["decode"] = {"logits": steps, "caches": _layers(caches, cfg.n_layers),
                     "folded": _layers(folded, cfg.n_layers),
                     "after_fold": jax.device_get(logits)}
    batch16 = dict(batch, frontend_embeds=batch["frontend_embeds"].astype(jnp.bfloat16))
    logits, caches = jregistry.prefill(params, batch16, cfg, ctx)
    out["prefill_bf16"] = {"logits": jax.device_get(logits),
                           "caches": _layers(caches, cfg.n_layers)}
    res = eng.generate(inputs)
    out["engine"] = {"tokens": res["tokens"], "bytes": eng.cache_bytes(eng.last_caches)}
    return {SEAMLESS: out}


def _seamless_long():
    """The lockstep engine on seamless at LONG_PROMPT bf16 source frames (a
    128-token decoder prompt)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core.policy import CompressionConfig
    from repro.serving import ServeConfig, ServingEngine

    ccfg = dataclasses.replace(CompressionConfig.zipcache(), **ccfg_kwargs())
    cfg = jconfigs.get_arch(SEAMLESS, smoke=True)
    params = jax.tree_util.tree_map(jnp.asarray, _params(cfg))
    eng = ServingEngine(cfg, ccfg, ServeConfig(BATCH, LONG_PROMPT, MAX_NEW), params)
    res = eng.generate(long_inputs(cfg))
    return {SEAMLESS: {"params": jax.device_get(params), "tokens": res["tokens"],
                       "bytes": eng.cache_bytes(eng.last_caches)}}


def _llava():
    """llava's frontend: `embed_inputs`, the lockstep engine's prefill and its
    greedy tokens."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core.policy import CompressionConfig
    from repro.models import lm as jlm
    from repro.models import registry as jregistry
    from repro.serving import ServeConfig, ServingEngine

    ccfg = dataclasses.replace(CompressionConfig.zipcache(), **ccfg_kwargs())
    cfg = jconfigs.get_arch(LLAVA, smoke=True)
    params = jax.tree_util.tree_map(jnp.asarray, _params(cfg))
    inputs = engine_inputs(cfg, PREFILL_LEN, PREFILL_LEN - cfg.n_frontend_tokens)
    eng = ServingEngine(cfg, ccfg, ServeConfig(BATCH, PREFILL_LEN, MAX_NEW), params)
    batch = {k: jnp.asarray(v) for k, v in inputs.items()}
    logits, caches = jregistry.prefill(params, batch, cfg, eng.ctx)
    sub0 = jax.device_get(caches["groups"]["sub0"])
    return {LLAVA: {
        "params": jax.device_get(params), "inputs": inputs,
        "embed": jax.device_get(jlm.embed_inputs(params, cfg, batch["tokens"],
                                                 batch["frontend_embeds"])),
        "logits": jax.device_get(logits),
        "caches": [{k: np.asarray(v[g]) for k, v in flat(sub0).items()}
                   for g in range(cfg.n_scan_groups)],
        "tokens": eng.generate(inputs)["tokens"]}}


PARTS = {"functions": _seamless_functions, "seamless-long": _seamless_long,
         "llava": _llava}


def run(tmp: Path, *parts: str) -> dict:
    """The references of `parts` (keys of `PARTS`), each computed op by op in a
    child process of its own, all at once, pickled under `tmp` and loaded
    back into one dict."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [(subprocess.Popen([sys.executable, "-m", "tests.encdec_reference", part,
                                str(tmp / f"{part}.pkl")], cwd=ROOT, env=env), part)
             for part in parts]
    out = {}
    try:
        for proc, part in procs:
            if proc.wait(timeout=900):
                raise RuntimeError(f"the reference's {part!r} run exited {proc.returncode}")
            with open(tmp / f"{part}.pkl", "rb") as f:
                for arch, refs in pickle.load(f).items():
                    out.setdefault(arch, {}).update(refs)
    finally:
        for proc, _ in procs:
            proc.kill()
    return out


if __name__ == "__main__":
    import jax

    with jax.disable_jit():
        refs = PARTS[sys.argv[1]]()
    with open(sys.argv[2], "wb") as f:
        pickle.dump(refs, f)
