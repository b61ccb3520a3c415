"""The JAX engines' runs that `tests/test_torch_hybrid.py` holds the port to:
mamba2-2.7b and jamba-v0.1-52b smoke on the lockstep and the continuous
engine, with their parameters, cache bytes, pool statistics and the
prefill states of the padding check.

They run in a child process (`run`), jitted with XLA's excess precision
off (`--xla_allow_excess_precision=false`, read once per process): each
bf16 operation then rounds on its own, as it does op by op
(`jax.disable_jit()`) and in the port.  Jitted with the default, XLA keeps
fused bf16 intermediates in f32 and the greedy tokens differ from both.
Op by op, the same runs take minutes of per-operation compiles.

    python -m tests.hybrid_reference OUT.pkl    (run() sets the flag)
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
MAMBA, JAMBA = "mamba2-2.7b", "jamba-v0.1-52b"
BATCH, PROMPT, MAX_NEW = 2, 64, 12
SHORT = 4    # the real tokens of the lockstep batch's row 1, behind 60 pads
CONT_LENGTHS = (64, 50, 64)     # one bucket (64 at page 16); the third repeats the first
CONT_NEW = 10
PAGE = 16
FREELIST = dict(backend="paged", page_size=PAGE, page_allocator="freelist", pool_fraction=0.75)
LAYOUTS = {
    "mixed": dict(backend="mixed", page_size=PAGE),
    "paged-static": dict(backend="paged", page_size=PAGE),
    "freelist": FREELIST,
    "prefix": dict(FREELIST, pool_fraction=1.5, prefix_cache=True),
}
REFERENCE_LAYOUT = {MAMBA: "mixed", JAMBA: "freelist"}   # the JAX continuous engine's
STATE_FIELDS = ("ssm", "conv_x", "conv_B", "conv_C")


def pack(prompts, b, prompt_len):
    """Left-pad and stack prompts (the engines' `pack_requests`)."""
    out = np.zeros((b, prompt_len), np.int32)
    for i, r in enumerate(prompts):
        out[i, prompt_len - len(r):] = r
    return out


def batch(vocab):
    rng = np.random.default_rng(0)
    return {"tokens": pack([rng.integers(2, vocab, size=(n,)).astype(np.int32)
                            for n in (PROMPT, SHORT)], BATCH, PROMPT)}


def prompts(vocab, lengths=CONT_LENGTHS):
    """Seeded prompts; under CONT_LENGTHS the third is the first again (a
    shared-prefix hit where dedup is on)."""
    rng = np.random.default_rng(5)
    out = [rng.integers(2, vocab, size=(n,)).astype(np.int32) for n in lengths]
    return out[:2] + [out[0]] if lengths == CONT_LENGTHS else out


def scenario(eng, request, ps):
    """Two slots; a short request retires after 3 tokens and a third,
    submitted mid-run, takes its slot."""
    r0 = eng.submit(request(tokens=ps[0]))
    r1 = eng.submit(request(tokens=ps[1], max_new_tokens=3))
    eng.step()
    r2 = eng.submit(request(tokens=ps[2]))
    res = eng.run()
    return [(res[r].tokens.tolist(), res[r].finish_reason) for r in (r0, r1, r2)]


def _reference(arch):
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import backend as jbackend
    from repro.core.policy import CompressionConfig
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

    cfg = jconfigs.get_arch(arch, smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    with jax.threefry_partitionable(True):
        params = jregistry.materialize_params(cfg, seed=0)
    b = batch(cfg.vocab)
    out = {"batch": b}
    eng = ServingEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, MAX_NEW), params)
    out["lockstep"] = eng.generate(b)["tokens"]
    out["lockstep_bytes"] = eng.cache_bytes(eng.last_caches)
    if arch == MAMBA:   # layer 0's state after the padded row 1 and after its tokens alone
        prefill = jax.jit(lambda p, t: jregistry.prefill(p, {"tokens": t}, cfg, eng.ctx)[1])
        toks = jnp.asarray(b["tokens"])
        out["states"] = []
        for t in (toks, toks[1:, PROMPT - SHORT:]):
            st = prefill(params, t)["groups"]["sub0"]
            out["states"].append({f: np.asarray(getattr(st, f)[0]) for f in STATE_FIELDS})
    with moe_admitted():
        ceng = ContinuousEngine(cfg, ccfg, ServeConfig(
            batch_size=BATCH, prompt_len=PROMPT, max_new_tokens=CONT_NEW,
            **LAYOUTS[REFERENCE_LAYOUT[arch]]), params)
    out["continuous"] = scenario(ceng, Request, prompts(cfg.vocab))
    out["continuous_bytes"] = jbackend.cache_bytes(ceng.caches)
    out["stats"] = ceng.pool_stats()
    out["params"] = jax.device_get(params)
    return out


def run(path: Path) -> dict:
    """The references, computed in a child process with XLA's excess
    precision off, pickled to `path` and loaded back."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    subprocess.run([sys.executable, "-m", "tests.hybrid_reference", str(path)], cwd=ROOT,
                   env=env, check=True, timeout=900)
    with open(path, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    if "--xla_allow_excess_precision=false" not in os.environ.get("XLA_FLAGS", ""):
        sys.exit("run through tests.hybrid_reference.run: XLA_FLAGS must turn excess "
                 "precision off")
    refs = {arch: _reference(arch) for arch in (MAMBA, JAMBA)}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(refs, f)
