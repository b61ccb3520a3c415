"""The serving levers on the MoE, MLA and SSM trees, held to the JAX engines
on the same parameters (`tests/levers_reference.py`, jitted in child
processes): DeepSeek-V2-Lite's smoke config (MLA + MoE, a dense prefix
layer), deepseek-moe-16b's (a GQA prefix layer at g = 1, then MoE) and
mamba2's (no KV element); the precision map's per-layer effective bits on
DeepSeek, Jamba and qwen2; the HTTP front on DeepSeek.

  * Lockstep under the precision map ("default=k8v8;layer:1-=k3v3"), on the
    kernel route (the kernels' plain versions on the CPU): tokens and
    `cache_bytes` equal the JAX engine's under the map, and the map bites.
  * The continuous engine over the paged free list, built in the reference
    with its MoE refusal hidden: the map, swap pressure and ladder pressure
    under the map on both trees; shared-prefix dedup and a seeded sampled
    run (requests 1 and 2 at T 0.8 / 1.0, seeds 3 / 5) on DeepSeek.  Every
    request is held to the JAX engine (tokens, finish reasons, events, the
    JAX keys of `pool_stats()`, `cache_bytes` with both slots live): at two
    slots a decode step's expert capacity (two pairs an expert) drops no
    pair, so the reference's empty-slot garbage rows take no pair from a
    live row, and no request needs holding to the port's own run instead.
    The sampled run draws no near tie (equal tokens throughout).
  * A swap round trip of a slot is bitwise on the prefix layer's element
    and on the groups' (pages and metadata rows scrambled in between, the
    payload through the host pool).
  * Each lever's static-buffer decode step bitwise the eager step on
    DeepSeek, through swap-in, alias admissions and copy-on-write copies,
    and downshift folds.
  * The map's effective bits per layer under a rung: every fold of
    `registry.recompress` (DeepSeek's prefix layer and its MLA groups on one
    latent head, Jamba's attention sub-layer in each group among its SSM
    layers, qwen2's layers) gets the reference's `precision.rung_eff` of
    `layer_eff` on `pooled_table`, in the same order.
  * mamba2 under the map: lockstep and continuous (mixed and paged static)
    tokens equal the run without the map and the JAX engine's (which takes
    the map: it never reads the table without a KV element); `cache_bytes`
    equal.
  * `HttpFrontend` on DeepSeek's smoke engine: a greedy and a sampled
    request; each stream's tokens equal its done event's, the engine's
    result and the same two requests on an engine without the front.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.core import backend as backend_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core import swap as swap_lib
from repro_torch.core.policy import CompressionConfig
from repro_torch.models import blocks, lm, registry
from repro_torch.serving import (ContinuousEngine, Request, SamplingParams, ServeConfig,
                                 ServingEngine)
from repro_torch.serving.http import HttpFrontend
from tests import levers_reference as lr
from tests.levers_reference import DSMOE, MAMBA, MLA
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
MOE = (MLA, DSMOE)
MOE_LEVERS = [(MLA, lever) for lever in lr.LEVERS[MLA]] + [(DSMOE, lever)
                                                            for lever in lr.LEVERS[DSMOE]]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return lr.run(tmp_path_factory.mktemp("levers_moe") / "refs.pkl",
                  [[f"{MLA}/swap,ladder"], [f"{MLA}/prefix,sampled,lockstep"],
                   [f"{DSMOE}/swap,ladder"], [f"{DSMOE}/lockstep"], [MAMBA, "effs"]])


def _port(refs, arch):
    cfg = lr.smoke(configs, arch)
    return cfg, convert.from_jax_params(refs[arch]["params"], cfg, device="cpu")


def _maker(cfg, params, capture=False, wrap=None):
    def make(kw):
        eng = ContinuousEngine(cfg, lr.ccfg(CompressionConfig), ServeConfig(**kw), params,
                               device="cpu", capture=capture)
        if wrap is not None:
            eng._decode_masked = wrap(eng._decode_masked)
        return eng
    return make


def _lockstep(cfg, params, pmap, prompt=lr.LOCK_PROMPT):
    eng = ServingEngine(cfg, lr.ccfg(CompressionConfig), ServeConfig(
        lr.LOCK_BATCH, prompt, lr.MAX_NEW, precision_map=pmap), params, device="cpu")
    tokens = eng.generate(lr.lock_batch(cfg.vocab))["tokens"]
    return tokens, eng.cache_bytes(eng.last_caches)


# ---- lockstep under the map -----------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_lockstep_under_the_map_matches_reference(refs, arch):
    cfg, params = _port(refs, arch)
    tokens, nbytes = _lockstep(cfg, params, lr.PRECISION_MAP)
    want_tokens, want_bytes = refs[arch]["lockstep-pmap"]
    np.testing.assert_array_equal(tokens, want_tokens)
    assert nbytes == want_bytes
    assert not np.array_equal(refs[arch]["lockstep"][0], want_tokens)   # the map bites


# ---- the continuous levers --------------------------------------------------------------

def _kinds(run):
    return [e["kind"] for e in run["events"] if e["kind"] != "TokenEvent"]


@pytest.mark.parametrize("arch,lever", MOE_LEVERS, ids=[f"{a}-{l}" for a, l in MOE_LEVERS])
def test_levers_match_reference(refs, arch, lever):
    cfg, params = _port(refs, arch)
    got = lr.lever_run(lever, _maker(cfg, params), Request, SamplingParams,
                       backend_lib.cache_bytes, lr.prompts(cfg.vocab))
    want = refs[arch][lever]
    assert got["outs"] == want["outs"]
    assert got["events"] == want["events"]
    st = got["stats"]
    assert {k: st[k] for k in lr.STAT_KEYS if k in want["stats"]} == \
        {k: want["stats"][k] for k in lr.STAT_KEYS if k in want["stats"]}
    assert got["bytes"] == want["bytes"]
    if not st["prefix"]["entries"]:
        assert all(st[seg]["used"] == 0 for seg in ("hi", "lo", "win"))
    kinds = _kinds(got)
    if lever == "swap":
        assert kinds.count("SwappedEvent") == 2 and "PreemptedEvent" not in kinds
        assert st["swap"]["host_bytes"] == 0 and st["swap"]["swaps_in"] == 1
    if lever == "prefix":
        assert st["prefix"]["hits"] >= 1 and st["prefix"]["cow_copies"] >= 1
    if lever == "ladder":
        assert st["downshift"]["downshifts"] >= 1 and st["downshift"]["pages_freed"] >= 1
    if lever == "sampled":   # the sampled requests' tokens are not the greedy run's
        greedy = lr.conformance_run(_maker(cfg, params), Request, backend_lib.cache_bytes,
                                    lr.prompts(cfg.vocab), lr.FREELIST)
        assert got["outs"][0] == greedy["outs"][0]
        assert all(got["outs"][i] != greedy["outs"][i] for i in lr.SAMPLED)


@pytest.mark.parametrize("arch", MOE)
def test_swap_round_trip_is_bitwise_with_the_prefix_layer(refs, arch):
    """A slot's payload out through the host pool and back: the prefix
    layer's element is in it (its pages and metadata rows first), and after
    every page and row of the slot is overwritten, the restore gives back
    every element's bytes bit for bit."""
    cfg, params = _port(refs, arch)
    eng = _maker(cfg, params)(dict(lr.FREELIST, scheduler="priority", preemption="swap"))
    for p in lr.prompts(cfg.vocab)[:2]:
        eng.submit(Request(tokens=p))
    for _ in range(5):
        eng.step()
    tree = eng.caches
    els = registry.cache_elements(tree)
    assert els[0] is tree["prefix"][0] and len(els) == cfg.n_layers
    with torch.inference_mode():
        payload = registry.extract_caches(tree, 0)
        n_prefix = len(registry.extract_caches({"prefix": tree["prefix"], "groups": []}, 0))
        assert 0 < n_prefix < len(payload)
        pool = swap_lib.HostSwapPool(payload, fallback_entries=1)
        handle = pool.reserve()
        pool.store(handle, payload)
        want = [t.clone() for t in payload]
        junk = registry.restore_caches(tree, [torch.full_like(t, 7) for t in payload], 0)
        scrambled = registry.extract_caches(junk, 0)
        assert all(not torch.equal(a, w) for a, w in zip(scrambled[:n_prefix], want[:n_prefix])
                   if w.numel() and bool((w != 7).any()))
        back = registry.restore_caches(junk, pool.load(handle, torch.device("cpu")), 0)
        pool.release(handle)
        got = registry.extract_caches(back, 0)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


class _Logits:
    """A continuous decode step that keeps the active rows' logits."""

    def __init__(self, step):
        self.step, self.logits = step, []

    def __call__(self, params, caches, staged):
        logits, caches = self.step(params, caches, staged)
        self.logits.append(logits[np.flatnonzero(staged[2]).tolist()].clone())
        return logits, caches

    def __getattr__(self, name):
        return getattr(self.step, name)


@pytest.mark.parametrize("lever", ["swap", "prefix", "ladder"])
def test_static_buffer_steps_equal_eager_on_deepseek(refs, lever):
    cfg, params = _port(refs, MLA)
    runs = []
    for capture in (False, True):
        recs = []

        def wrap(step):
            recs.append(_Logits(step))
            return recs[-1]

        run = lr.lever_run(lever, _maker(cfg, params, capture=capture, wrap=wrap), Request,
                           SamplingParams, backend_lib.cache_bytes, lr.prompts(cfg.vocab))
        runs.append((run, recs[0]))
    (eager, e_rec), (static, s_rec) = runs
    assert static["outs"] == eager["outs"] == refs[MLA][lever]["outs"]
    assert s_rec.captures == 1 and s_rec.replays > 0 and e_rec.captures == 0
    assert len(s_rec.logits) == len(e_rec.logits) > 0
    assert all(torch.equal(a, w) for a, w in zip(s_rec.logits, e_rec.logits))


# ---- the map's layer index ---------------------------------------------------------------

@pytest.mark.parametrize("arch", lr.EFF_ARCHS)
def test_layer_eff_under_a_rung_matches_reference(refs, arch):
    """Every fold's effective bits at rungs (0, 2) equal the reference's, in
    layer order.  The map (`levers_reference.EFF_MAP`) gives layers 0, 1
    and 2- their own bits, so an index off by the prefix layer or by the
    SSM layers shows; each fold's bits also equal the table row of its
    layer (MLA's one latent head the strictest of the row)."""
    cfg = configs.get_arch(arch, smoke=True)
    table = precision_lib.parse_precision_map(lr.EFF_MAP).resolve(cfg.n_layers, cfg.n_kv_heads)
    want = refs["effs"][arch]
    np.testing.assert_array_equal(table, want["table"])
    rec = lr.Recording(backend_lib.of(lr.ccfg(CompressionConfig), kind="mixed"),
                       lambda t: t.numpy())
    ctx = blocks.RunCtx(ccfg=lr.ccfg(CompressionConfig), max_cache_len=32, backend=rec,
                        precision=table)
    registry.recompress(registry.init_caches(cfg, ctx, 2, device="cpu"), cfg, ctx,
                        rows=torch.tensor(lr.EFF_ROWS),
                        rung=torch.tensor(lr.EFF_RUNGS, dtype=torch.int32))
    kv_layers = [layer for layer, mixer, _, _ in lm.layers(cfg) if mixer != "ssm"]
    assert len(rec.effs) == len(want["effs"]) == len(kv_layers) > 0
    for layer, got, jgot in zip(kv_layers, rec.effs, want["effs"]):
        for g, w in zip(got, jgot):
            shape = np.broadcast_shapes(g.shape, w.shape)
            np.testing.assert_array_equal(np.broadcast_to(g, shape), np.broadcast_to(w, shape))
        # hi_k at both rungs min(4, the layer's key ceiling); lo_k at rung 2
        # two bits below min(2, ceiling), at least 1
        ceil = int(table[layer].min(axis=0)[0]) if cfg.mla else int(table[layer, 0, 0])
        assert float(got[0].reshape(-1)[0]) == min(4, ceil)
        assert float(got[2].reshape(2, -1)[1, 0]) == max(1, min(2, ceil) - 2)


# ---- mamba2 under the map -----------------------------------------------------------------

def test_mamba2_lockstep_ignores_the_map(refs):
    cfg, params = _port(refs, MAMBA)
    mapped, plain = (_lockstep(cfg, params, pmap) for pmap in (lr.PRECISION_MAP, ""))
    np.testing.assert_array_equal(mapped[0], plain[0])
    assert mapped[1] == plain[1]
    for key in ("lockstep-pmap", "lockstep"):
        np.testing.assert_array_equal(mapped[0], refs[MAMBA][key][0])
        assert mapped[1] == refs[MAMBA][key][1]


@pytest.mark.parametrize("layout", sorted(lr.SSM_LAYOUTS))
def test_mamba2_continuous_ignores_the_map(refs, layout):
    cfg, params = _port(refs, MAMBA)
    runs = [lr.conformance_run(_maker(cfg, params), Request, backend_lib.cache_bytes,
                               lr.prompts(cfg.vocab, length=64),
                               dict(lr.SSM_LAYOUTS[layout], precision_map=pmap))
            for pmap in (lr.PRECISION_MAP, "")]
    want = refs[MAMBA][f"continuous-pmap-{layout}"]
    for run in runs:
        assert run["outs"] == want["outs"] and run["bytes"] == want["bytes"]
        assert run["bytes"]["packed_bytes"] == 0


# ---- the HTTP front on an MLA tree ---------------------------------------------------------

HTTP_REQUESTS = ({"max_new_tokens": 8}, {"max_new_tokens": 8, "temperature": 0.7, "seed": 3})


async def _generate(port, payload):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode()
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    status = (await reader.readline()).decode()
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    tokens, final = [], None
    while final is None:
        line = (await reader.readline()).strip()
        if line.startswith(b"data: "):
            d = json.loads(line[6:])
            if "token" in d:
                tokens.append(d["token"])
            else:
                final = d
    writer.close()
    return status, tokens, final


def test_http_front_on_deepseek(refs):
    cfg, params = _port(refs, MLA)
    make = _maker(cfg, params)
    ps = lr.prompts(cfg.vocab, n=2, length=24)
    specs = [dict(spec, tokens=p.tolist()) for spec, p in zip(HTTP_REQUESTS, ps)]

    async def serve(eng):
        front = HttpFrontend(eng, port=0)
        await front.start()
        try:
            return await asyncio.gather(*(_generate(front.port, s) for s in specs))
        finally:
            await front.stop(drain=False)

    eng = make(lr.FREELIST)
    answers = asyncio.run(serve(eng))
    alone = make(lr.FREELIST)
    rids = [alone.submit(Request(tokens=p, max_new_tokens=8, sampling=SamplingParams(
        s.get("temperature", 0.0), s.get("seed", 0)))) for p, s in zip(ps, specs)]
    res = alone.run()
    for (status, tokens, final), rid in zip(answers, rids):
        assert "200" in status and final["finish_reason"] == "length"
        assert tokens == final["tokens"] == eng.result(final["id"]).tokens.tolist()
        assert tokens == res[rid].tokens.tolist() and len(tokens) == 8
