"""The JAX engines' runs that `tests/test_torch_policies_continuous.py`,
`tests/test_torch_cache_bytes.py`, `tests/test_torch_policies_lockstep.py`
and `tests/test_torch_continuous.py` hold the port to, computed jitted in
a child process per job (`run`): XLA's excess precision
and algebraic simplifier off (every bf16 operation rounds on its own, as
the op-by-op run's do; tests/configs_reference.py says why) and a
persistent compilation cache beside the pickles.  The scenario functions
take the engine factory and the request class, so the tests drive the port
through the same code.

Jobs (yi-6b smoke, zipcache presets at fp_window = recompress_interval =
8, `materialize_params(cfg, 0)`, returned as numpy):
  * `policies` -- `serve_policy` for each of `POLICY_CASES`: the
    continuous engine's greedy tokens and streams;
  * `cache_bytes` -- `lockstep_bytes` and `constrained_bytes` on each of
    `ALLOCATORS`: `cache_bytes` after a generate, after every step and on
    the drained engine, with the tokens;
  * `lockstep_policies` -- the lockstep engine's greedy tokens under each
    of `LOCKSTEP_POLICIES` (`lockstep_batch`);
  * `continuous` -- `continuous_scenario` on each of `CONTINUOUS_LAYOUTS`:
    the outputs, their streams and the pool stats;
  * `moe_continuous` -- DeepSeek-V2-Lite smoke (drawn under
    `jax.threefry_partitionable(True)`) on the continuous engine over the
    paged free list, its MoE check hidden while it is built (`moe_admitted`:
    the reference refuses MoE archs there): `moe_scenario`'s tokens and the
    pool stats;
  * `mla_lockstep` -- the same smoke model on the lockstep engine:
    `mla_batch`'s prefill logits (f32) and greedy tokens.

    python -m tests.serving_reference OUT.pkl JOB [JOB ...]   (run() sets the flags)
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

# tests/test_torch_policies_continuous.py's scenario
PROMPTS, BUDGETS = (24, 15, 20), (10, 5, 10)
POLICY_LAYOUTS = {"mixed": (dict(backend="mixed"), dict(backend="mixed")),
                  "paged-freelist-walk": (dict(backend="paged", page_allocator="freelist",
                                               pool_fraction=0.75, paged_kernel=True),
                                          dict(backend="paged"))}
POLICY_CASES = [(p, "paged-freelist-walk") for p in ("mikv", "h2o", "fp16", "gear", "kivi")] + [
    ("kivi", "mixed")]

# tests/test_torch_cache_bytes.py's scenarios
ALLOCATORS = {"static": dict(page_allocator="static"),
              "freelist": dict(page_allocator="freelist", pool_fraction=0.75)}
BYTE_BUDGETS = (40, 4, 40, 4)

# tests/test_torch_policies_lockstep.py's scenario
LOCKSTEP_POLICIES = ("mikv", "h2o", "fp16", "gear", "kivi")
LOCK_BATCH, LOCK_PROMPT, LOCK_NEW = 2, 24, 10

# tests/test_torch_continuous.py's scenario (tests/test_backend_conformance.py's)
CONTINUOUS_PROMPTS = (48, 30, 41)
CONTINUOUS_LAYOUTS = {
    "mixed": dict(backend="mixed"),
    "paged": dict(backend="paged"),
    "paged-freelist": dict(backend="paged", page_allocator="freelist", pool_fraction=0.75),
}


def ccfg(cls, policy="zipcache"):
    return dataclasses.replace(cls.preset(policy), fp_window=8, recompress_interval=8)


def policy_prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=(n,)).astype(np.int32) for n in PROMPTS]


def serve_policy(eng, request, prompts):
    """(tokens per request, their streams): three ragged requests drained
    through `stream()`."""
    rids = [eng.submit(request(tokens=p, max_new_tokens=m)) for p, m in zip(prompts, BUDGETS)]
    streams = [list(eng.stream(r)) for r in rids]
    return [eng.result(r).tokens.tolist() for r in rids], streams


def lockstep_bytes(make, pack, vocab):
    """(cache_bytes of `last_caches`, tokens) of tests/test_serving.py's
    scenario: 2 prompts of 48 tokens, 4 new tokens, mixed layout."""
    rng = np.random.default_rng(0)
    toks = [rng.integers(2, vocab, size=(48,)).astype(np.int32) for _ in range(2)]
    eng = make(dict(batch_size=2, prompt_len=48, max_new_tokens=4))
    out = eng.generate({"tokens": pack(toks, 2, 48)})
    return eng.cache_bytes(eng.last_caches), np.asarray(out["tokens"]).tolist()


def constrained_bytes(make, request, vocab, kw):
    """(cache_bytes after every step, tokens per request, the drained
    engine's cache_bytes) of tests/test_page_alloc.py's constrained
    engines: budgets 40/4/40/4 over 2 slots, page 8, 8-token prompts."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab, size=(8,)).astype(np.int32) for _ in range(4)]
    eng = make(dict(batch_size=2, prompt_len=8, max_new_tokens=40, backend="paged",
                    page_size=8, **kw))
    rids = [eng.submit(request(tokens=p, max_new_tokens=m))
            for p, m in zip(prompts, BYTE_BUDGETS)]
    per_step = []
    while eng.pending:
        eng.step()
        per_step.append(eng.cache_bytes(eng.caches))
    return per_step, [eng.result(r).tokens.tolist() for r in rids], eng.cache_bytes(eng.caches)


def lockstep_batch(vocab, pack):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab, size=(LOCK_PROMPT,)).astype(np.int32)
               for _ in range(LOCK_BATCH)]
    return {"tokens": pack(prompts, LOCK_BATCH, LOCK_PROMPT)}


def continuous_prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=(n,)).astype(np.int32) for n in CONTINUOUS_PROMPTS]


def continuous_scenario(eng, request, prompts):
    """Submit, drive, drain through streams -> (outputs, streams, pool
    stats): a short request retiring after 6 tokens, a third submitted
    mid-run into the freed slot."""
    r0 = eng.submit(request(tokens=prompts[0]))
    r1 = eng.submit(request(tokens=prompts[1], max_new_tokens=6))
    for _ in range(4):
        eng.step()
    r2 = eng.submit(request(tokens=prompts[2]))   # mid-run: waits for r1's slot
    streams = {r: list(eng.stream(r)) for r in (r0, r1, r2)}
    res = eng.run()
    return [res[r] for r in (r0, r1, r2)], [streams[r] for r in (r0, r1, r2)], eng.pool_stats()


# tests/test_torch_moe.py's engine scenario
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_PROMPTS, MOE_PROMPT_LEN, MOE_NEW = (24, 16, 20), 24, 10
MOE_FREELIST = dict(backend="paged", page_size=8, page_allocator="freelist", pool_fraction=0.75)


def moe_prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(2, vocab, size=(n,)).astype(np.int32) for n in MOE_PROMPTS]


def moe_scenario(eng, request, prompts):
    """Two slots; a short request retires after 3 tokens and a third,
    submitted mid-run, takes its slot: [(tokens, finish reason)]."""
    r0 = eng.submit(request(tokens=prompts[0]))
    r1 = eng.submit(request(tokens=prompts[1], max_new_tokens=3))
    eng.step()
    r2 = eng.submit(request(tokens=prompts[2]))
    res = eng.run()
    return [(res[r].tokens.tolist(), res[r].finish_reason) for r in (r0, r1, r2)]


# tests/test_torch_mla.py's engine scenario
MLA_BATCH, MLA_PROMPT, MLA_NEW = 2, 48, 12


def mla_batch(vocab, pack):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, vocab, size=(MLA_PROMPT,)).astype(np.int32)
               for _ in range(MLA_BATCH)]
    return {"tokens": pack(prompts, MLA_BATCH, MLA_PROMPT)}


@contextlib.contextmanager
def moe_admitted():
    """Hide `n_experts` from the reference EngineCore's MoE check (its only
    `getattr` of that name) while a JAX ContinuousEngine is built."""
    from repro.serving import engine as jengine

    def shim(obj, name, *default):
        return 0 if name == "n_experts" else builtins.getattr(obj, name, *default)

    jengine.getattr = shim
    try:
        yield
    finally:
        del jengine.getattr


def _reference(job: str) -> dict:
    import jax
    from repro import configs
    from repro.core.policy import CompressionConfig
    from repro.models import registry
    from repro.serving import ContinuousEngine, Request, ServeConfig, ServingEngine
    from repro.serving import pack_requests

    if job in ("moe_continuous", "mla_lockstep"):
        cfg = configs.get_arch(MOE_ARCH, smoke=True)
        with jax.threefry_partitionable(True):
            params = registry.materialize_params(cfg, seed=0)
    if job == "mla_lockstep":
        import jax.numpy as jnp
        batch = mla_batch(cfg.vocab, pack_requests)
        eng = ServingEngine(cfg, ccfg(CompressionConfig),
                            ServeConfig(MLA_BATCH, MLA_PROMPT, MLA_NEW), params)
        logits, _ = jax.jit(lambda p, t: registry.prefill(p, {"tokens": t}, cfg, eng.ctx))(
            params, jnp.asarray(batch["tokens"]))
        return {"params": jax.device_get(params), "batch": batch,
                "tokens": np.asarray(eng.generate(batch)["tokens"]),
                "logits": np.asarray(logits.astype(jnp.float32))}
    if job == "moe_continuous":
        with moe_admitted():
            eng = ContinuousEngine(cfg, ccfg(CompressionConfig),
                                   ServeConfig(batch_size=2, prompt_len=MOE_PROMPT_LEN,
                                               max_new_tokens=MOE_NEW, **MOE_FREELIST), params)
        return {"params": jax.device_get(params),
                "tokens": moe_scenario(eng, Request, moe_prompts(cfg.vocab)),
                "stats": eng.pool_stats()}
    cfg = configs.get_arch("yi-6b", smoke=True)
    params = registry.materialize_params(cfg, seed=0)
    out = {"params": jax.device_get(params)}
    if job == "policies":
        for policy, layout in POLICY_CASES:
            scfg = ServeConfig(batch_size=2, prompt_len=24, max_new_tokens=10, page_size=8,
                               **POLICY_LAYOUTS[layout][1])
            eng = ContinuousEngine(cfg, ccfg(CompressionConfig, policy), scfg, params)
            out[policy, layout] = serve_policy(eng, Request, policy_prompts(cfg.vocab))[0]
    elif job == "cache_bytes":
        zc = ccfg(CompressionConfig)
        out["lockstep"] = lockstep_bytes(
            lambda kw: ServingEngine(cfg, zc, ServeConfig(**kw), params), pack_requests,
            cfg.vocab)
        for name, kw in ALLOCATORS.items():
            out[name] = constrained_bytes(
                lambda kw_: ContinuousEngine(cfg, zc, ServeConfig(**kw_), params), Request,
                cfg.vocab, kw)
    elif job == "lockstep_policies":
        for policy in LOCKSTEP_POLICIES:
            eng = ServingEngine(cfg, ccfg(CompressionConfig, policy),
                                ServeConfig(LOCK_BATCH, LOCK_PROMPT, LOCK_NEW), params)
            out[policy] = np.asarray(eng.generate(lockstep_batch(cfg.vocab, pack_requests))
                                     ["tokens"])
    elif job == "continuous":
        zc = ccfg(CompressionConfig)
        for name, kw in CONTINUOUS_LAYOUTS.items():
            scfg = ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8, **kw)
            eng = ContinuousEngine(cfg, zc, scfg, params)
            out[name] = continuous_scenario(eng, Request, continuous_prompts(cfg.vocab))
    else:
        raise ValueError(job)
    return out


def run(path: Path, job: str) -> dict:
    """The reference's run of `job` in a child process (flags above),
    pickled at `path` and loaded back."""
    env = dict(os.environ)
    env["JAX_COMPILATION_CACHE_DIR"] = str(path.with_name(f"{path.stem}.jaxcache"))
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "0"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
                        + " --xla_disable_hlo_passes=algsimp").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen([sys.executable, "-m", "tests.serving_reference", str(path), job],
                            cwd=ROOT, env=env)
    try:
        if proc.wait(timeout=900) != 0:
            raise RuntimeError(f"tests.serving_reference exited {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(path, "rb") as f:
        return pickle.load(f)[job]


if __name__ == "__main__":
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_allow_excess_precision=false" not in flags or "algsimp" not in flags:
        sys.exit("run through tests.serving_reference.run: XLA_FLAGS must turn excess "
                 "precision and the algebraic simplifier off")
    refs = {job: _reference(job) for job in sys.argv[2:]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(refs, f)
