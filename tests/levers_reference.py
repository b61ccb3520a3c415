"""The JAX engines' runs that `tests/test_torch_levers_trees.py` and
`tests/test_torch_levers_moe.py` hold the port's serving levers to, on the
trees beyond yi-6b: the g = 7 variant of qwen2-7b's smoke config and
smollm-360m's (g = 3), DeepSeek-V2-Lite's (MLA + MoE, a dense prefix
layer), deepseek-moe-16b's (a GQA prefix layer, then MoE) and mamba2's (no
KV element).

The scenarios are tests/test_backend_conformance.py's, two slots at page 8
with fp_window 8 and recompress_interval 8 (probe steps and folds within 12
tokens), every free-list run at 1.5x the worst case (one pool shape, so
the engines of an arch share their compiled programs; the ladder still
fires at watermark 0.6, and the swap victim is forced by priority): the
precision map ("default=k8v8;layer:1-=k3v3") on the free list, the downshift ladder armed as the preemption policy, the swap and
ladder pressure runs (under the map, as the card's phase 4e runs them),
shared-prefix dedup on one shared prompt, and for DeepSeek a seeded
sampled run; then the baselines (fp16, h2o, mikv, gear, kivi) on the
lockstep engine and fp16 / kivi on the continuous engine over the paged
static layout (the JAX free list cannot admit a zero-capacity store:
ROADMAP.md §3).  The scenario functions take the engine factory and the
request classes, so the port's tests drive the port through the same
code.

The reference refuses MoE archs on its continuous engine; that one check
is hidden while it is built (`moe_admitted`, as tests/hybrid_reference.py
does for Jamba).  At two slots a decode step's expert capacity (two pairs
an expert at the smoke configs' 4 experts) drops no pair, so an empty
slot's garbage row in the reference takes no pair from a live row.

The runs are jitted with XLA's excess precision and its algebraic
simplifier off (tests/configs_reference.py says why), in child processes
(`run`), one per group of archs, all at once.

    python -m tests.levers_reference OUT.pkl JOB [JOB ...]   (run() sets the flags)
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

from tests import configs_reference as cr

ROOT = Path(__file__).resolve().parents[1]
G7, SMOL, DSMOE = cr.G7, cr.SMOL, cr.DSMOE
MLA, MAMBA = "deepseek-v2-lite-16b", "mamba2-2.7b"
PRECISION_MAP = "default=k8v8;layer:1-=k3v3"   # tests/test_backend_conformance.py's
PROMPT, MAX_NEW, PAGE = 48, 12, 8
BASE = dict(batch_size=2, prompt_len=PROMPT, max_new_tokens=MAX_NEW, page_size=PAGE)
FREELIST = dict(BASE, backend="paged", page_allocator="freelist", pool_fraction=1.5)
PAGED_STATIC = dict(BASE, backend="paged")
# mamba2's layouts: 64-token prompts at page 16 (the reference's SSD takes
# no ragged chunk: a 48-token bucket fails its assert, ROADMAP.md §3)
SSM_BASE = dict(BASE, prompt_len=64, page_size=16)
SSM_LAYOUTS = {"mixed": SSM_BASE, "paged-static": dict(SSM_BASE, backend="paged")}
SHARED = np.arange(2, 26, dtype=np.int32)      # the prefix scenario's 24-token prompt
LOCK_BATCH, LOCK_PROMPT = 2, 32
LOCKSTEP_POLICIES = ("fp16", "h2o", "mikv", "gear", "kivi")
CONTINUOUS_POLICIES = ("fp16", "kivi")
SAMPLED = {1: (0.8, 3), 2: (1.0, 5)}           # request index: (temperature, seed)
STAT_KEYS = ("hi", "lo", "win", "deferrals", "preemptions", "downshift", "prefix", "swap")
# the continuous lever runs of each arch (mamba2 has no free list: ROADMAP.md §3)
LEVERS = {G7: ("pmap", "swap", "prefix", "ladder"), SMOL: ("pmap", "swap", "prefix", "ladder"),
          MLA: ("swap", "prefix", "ladder", "sampled"),
          DSMOE: ("swap", "ladder"), MAMBA: ()}
BASELINES = (G7, SMOL)
MAPPED_LOCKSTEP = (MLA, DSMOE, MAMBA)


def smoke(configs, arch):
    return cr.smoke(configs, arch)


def ccfg(cls, policy="zipcache"):
    return dataclasses.replace(cls.preset(policy), fp_window=8, recompress_interval=8)


def prompts(vocab, n=3, length=PROMPT):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=(length,)).astype(np.int32) for _ in range(n)]


def lock_batch(vocab):
    rng = np.random.default_rng(3)
    out = np.zeros((LOCK_BATCH, LOCK_PROMPT), np.int32)
    for i, n in enumerate((LOCK_PROMPT, LOCK_PROMPT - 7)):   # row 1 left-padded
        out[i, LOCK_PROMPT - n:] = rng.integers(2, vocab, size=(n,))
    return {"tokens": out}


def _events(events):
    return [dataclasses.asdict(e) | {"kind": type(e).__name__} for e in events]


def _drain(eng, rids, events, cache_bytes):
    while eng.pending:
        events += eng.step()
        if eng._alloc is not None:
            eng._alloc.check_invariants()
    outs = [(eng.result(r).tokens.tolist(), eng.result(r).finish_reason) for r in rids]
    return dict(outs=outs, stats=eng.pool_stats(), events=_events(events), bytes=cache_bytes)


def conformance_run(make, request, cache_bytes, ps, kw):
    """tests/test_backend_conformance.py's engine scenario: a 6-token
    request retires, a third is admitted mid-run into its slot; the cache
    bytes read after the fourth step, with both slots live."""
    eng = make(kw)
    rids = [eng.submit(request(tokens=ps[0])), eng.submit(request(tokens=ps[1], max_new_tokens=6))]
    events = []
    for _ in range(4):
        events += eng.step()
    mid = cache_bytes(eng.caches)
    rids.append(eng.submit(request(tokens=ps[2])))
    return _drain(eng, rids, events, mid)


def swap_run(make, request, cache_bytes, ps, kw):
    """The swap-pressure scenario: two priority-0 longs, then a priority-2
    short that forces a victim once both slots are held."""
    eng = make(dict(kw, scheduler="priority"))
    rids = [eng.submit(request(tokens=ps[0])), eng.submit(request(tokens=ps[1]))]
    events = []
    for _ in range(4):
        events += eng.step()
    mid = cache_bytes(eng.caches)
    rids.append(eng.submit(request(tokens=ps[2], max_new_tokens=3, priority=2)))
    return _drain(eng, rids, events, mid)


def prefix_run(make, request, cache_bytes, kw):
    """The shared-prompt dedup scenario: four requests on one 24-token
    prompt (the fourth never folds)."""
    eng = make(kw)
    reqs = [request(tokens=SHARED.copy(), id=f"r{i}") for i in range(3)]
    reqs.append(request(tokens=SHARED.copy(), id="r3", max_new_tokens=4))
    rids = [eng.submit(r) for r in reqs]
    return _drain(eng, rids, [], None)


def sampled_run(make, request, sampling, cache_bytes, ps, kw):
    """The conformance scenario with requests 1 and 2 sampled (SAMPLED)."""
    eng = make(kw)
    rids = [eng.submit(request(tokens=ps[0])),
            eng.submit(request(tokens=ps[1], max_new_tokens=6, sampling=sampling(*SAMPLED[1])))]
    events = []
    for _ in range(4):
        events += eng.step()
    rids.append(eng.submit(request(tokens=ps[2], sampling=sampling(*SAMPLED[2]))))
    return _drain(eng, rids, events, None)


def lever_run(lever, make, request, sampling, cache_bytes, ps):
    """One of LEVERS' runs through `make` (a ServeConfig kwargs -> engine
    factory)."""
    mapped = dict(FREELIST, precision_map=PRECISION_MAP)
    if lever == "pmap":
        return conformance_run(make, request, cache_bytes, ps, mapped)
    if lever == "downshift":
        return conformance_run(make, request, cache_bytes, ps,
                               dict(mapped, scheduler="priority", preemption="downshift"))
    if lever == "swap":
        return swap_run(make, request, cache_bytes, ps,
                        dict(mapped, preemption="swap", swap_pool_mb=1))
    if lever == "prefix":
        return prefix_run(make, request, cache_bytes, dict(FREELIST, prefix_cache=True))
    if lever == "ladder":
        return conformance_run(make, request, cache_bytes, ps, dict(mapped, ladder_watermark=0.6))
    if lever == "sampled":
        return sampled_run(make, request, sampling, cache_bytes, ps, FREELIST)
    raise ValueError(lever)


class Recording:
    """A cache backend whose folds record their effective bits (as numpy, by
    `to_np`) and change nothing; everything else is the wrapped backend's."""

    def __init__(self, inner, to_np):
        self.inner, self.to_np, self.effs = inner, to_np, []

    def recompress(self, el, rows=None, eff=None):
        self.effs.append(tuple(self.to_np(getattr(eff, f)) for f in eff._fields))
        return el

    def __getattr__(self, name):
        return getattr(self.inner, name)


EFF_ARCHS = (MLA, "jamba-v0.1-52b", "qwen2-7b")
EFF_MAP = "default=k8v8;layer:1=k3v1;layer:2-=k1v3"   # every layer's four bits its own
EFF_ROWS, EFF_RUNGS = (True, True), (0, 2)


def _effs(arch):
    """The effective bits of every fold of `registry.recompress` under
    EFF_MAP at rungs EFF_RUNGS, in call order (op by op: the scan's layer
    index concrete), over the smoke config's empty mixed caches."""
    import jax

    from repro import configs as jconfigs
    from repro.core import backend as jbackend
    from repro.core import precision as jprecision
    from repro.core.policy import CompressionConfig
    from repro.models import blocks as jblocks
    from repro.models import registry as jregistry

    cfg = jconfigs.get_arch(arch, smoke=True)
    table = jprecision.parse_precision_map(EFF_MAP).resolve(cfg.n_layers, cfg.n_kv_heads)
    rec = Recording(jbackend.of(ccfg(CompressionConfig), kind="mixed"), np.asarray)
    with jax.disable_jit():
        ctx = jblocks.RunCtx(ccfg=ccfg(CompressionConfig), max_cache_len=32, backend=rec,
                             precision=table)
        jregistry.recompress(jregistry.init_caches(cfg, ctx, 2), cfg, ctx,
                             rows=np.array(EFF_ROWS), rung=np.array(EFF_RUNGS, np.int32))
    return {"table": table, "effs": rec.effs}


def _reference(job):
    """job: "ARCH" (every run of that arch) or "ARCH/RUN[,RUN ...]": a run
    is a lever of LEVERS, "lockstep" (MAPPED_LOCKSTEP's runs with and
    without the map), "ssm" (mamba2's mapped continuous runs), "baselines"
    (BASELINES' runs) or "effs" (the fold's bits of EFF_ARCHS)."""
    import jax

    from repro import configs as jconfigs
    from repro.core import backend as jbackend
    from repro.core.policy import CompressionConfig
    from repro.models import registry as jregistry
    from repro.serving import (ContinuousEngine, Request, SamplingParams, ServeConfig,
                               ServingEngine)
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

    arch, _, part = job.partition("/")
    if arch == "effs":
        return {a: _effs(a) for a in EFF_ARCHS}
    runs = part.split(",") if part else [*LEVERS[arch], "lockstep", "ssm", "baselines"]
    cfg = smoke(jconfigs, arch)
    with jax.threefry_partitionable(True):
        params = jax.device_get(jregistry.materialize_params(cfg, seed=0))
    if cfg.qkv_bias:
        params = cr.with_random_bias(params)
    out = {"params": params}

    def make_for(policy):
        def make(kw):
            with moe_admitted():
                return ContinuousEngine(cfg, ccfg(CompressionConfig, policy), ServeConfig(**kw),
                                        params)
        return make

    ps = prompts(cfg.vocab)
    with jax.threefry_partitionable(True):
        for lever in (r for r in runs if r in LEVERS[arch]):
            out[lever] = lever_run(lever, make_for("zipcache"), Request, SamplingParams,
                                   jbackend.cache_bytes, ps)
    b = lock_batch(cfg.vocab)
    if arch in MAPPED_LOCKSTEP and "lockstep" in runs:
        for pmap in ("", PRECISION_MAP):
            eng = ServingEngine(cfg, ccfg(CompressionConfig), ServeConfig(
                LOCK_BATCH, LOCK_PROMPT, MAX_NEW, precision_map=pmap), params)
            out[f"lockstep{'-pmap' if pmap else ''}"] = (eng.generate(b)["tokens"],
                                                         eng.cache_bytes(eng.last_caches))
    if arch == MAMBA and "ssm" in runs:
        for layout, kw in SSM_LAYOUTS.items():
            out[f"continuous-pmap-{layout}"] = conformance_run(
                make_for("zipcache"), Request, jbackend.cache_bytes, prompts(cfg.vocab, length=64),
                dict(kw, precision_map=PRECISION_MAP))
    if arch in BASELINES and "baselines" in runs:
        for policy in LOCKSTEP_POLICIES:
            eng = ServingEngine(cfg, ccfg(CompressionConfig, policy),
                                ServeConfig(LOCK_BATCH, LOCK_PROMPT, MAX_NEW), params)
            out[f"lockstep-{policy}"] = (eng.generate(b)["tokens"],
                                         eng.cache_bytes(eng.last_caches))
        for policy in CONTINUOUS_POLICIES:
            out[f"continuous-{policy}"] = conformance_run(
                make_for(policy), Request, jbackend.cache_bytes, ps, PAGED_STATIC)
    return out


def run(path: Path, groups) -> dict:
    """The references of `groups` (one child process per group of jobs, all
    at once), with XLA's excess precision and algebraic simplifier off,
    pickled beside `path` and loaded back: {arch: {run: result}}.  The
    children share a persistent compilation cache beside `path`: the
    engines of one arch compile the same programs again and again."""
    env = dict(os.environ)
    env["JAX_COMPILATION_CACHE_DIR"] = str(path.with_name(f"{path.stem}.jaxcache"))
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "0"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
                        + " --xla_disable_hlo_passes=algsimp").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    parts = [path.with_name(f"{path.stem}.{i}{path.suffix}") for i in range(len(groups))]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.levers_reference", str(p), *archs],
                              cwd=ROOT, env=env) for p, archs in zip(parts, groups)]
    try:
        for proc in procs:
            if proc.wait(timeout=900) != 0:
                raise RuntimeError(f"tests.levers_reference exited {proc.returncode}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    refs = {}
    for p in parts:
        with open(p, "rb") as f:
            for job, out in pickle.load(f).items():
                refs.setdefault(job.partition("/")[0], {}).update(out)
    return refs


if __name__ == "__main__":
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_allow_excess_precision=false" not in flags or "algsimp" not in flags:
        sys.exit("run through tests.levers_reference.run: XLA_FLAGS must turn excess "
                 "precision and the algebraic simplifier off")
    refs = {job: _reference(job) for job in sys.argv[2:]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(refs, f)
