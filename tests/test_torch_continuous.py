"""Port parity for slice 2: the continuous engine over the mixed, paged-static
and paged free-list layouts (and the page walk), against the JAX package's
`ContinuousEngine` on yi-6b smoke (zipcache, fp_window 8, recompress
interval 8), with the JAX parameters carried over by `convert`.

The scenario is tests/test_backend_conformance.py's, with ragged prompts
(48, 30, 41 tokens: three admission buckets at page 8): two slots, a short
request retiring after 6 tokens, a third request submitted mid-run and
admitted into the freed slot, windows folding on each slot's own cadence.
The free-list variant runs at pool_fraction 0.75, where the pools hold one
request's worst case at a time, so admissions defer.  Requests are drained
through `stream()`.  Greedy tokens must equal the reference exactly.

The JAX engines run op by op (`jax.disable_jit()`), as in
tests/test_torch_slice.py, and only the gather path: JAX's own tests hold
its Pallas kernel to that path token for token.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core.policy import CompressionConfig as JCompression
from repro.models import registry as jregistry
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.launch import serve
from repro_torch.serving import (CancelledEvent, ContinuousEngine, PreemptedEvent, Request,
                                 ServeConfig, ServingEngine, pack_requests)
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
PROMPTS = (48, 30, 41)
LAYOUTS = {
    "mixed": dict(backend="mixed"),
    "paged": dict(backend="paged"),
    "paged-freelist": dict(backend="paged", page_allocator="freelist", pool_fraction=0.75),
}
# the port's variants, and the reference layout each is held to
VARIANTS = {**{k: (v, k) for k, v in LAYOUTS.items()},
            "paged-kernel": (dict(LAYOUTS["paged-freelist"], paged_kernel=True),
                             "paged-freelist")}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=(n,)).astype(np.int32) for n in PROMPTS]


def _scenario(eng, request, prompts):
    """Submit, drive, drain through streams -> (outputs, streams, pool stats)."""
    r0 = eng.submit(request(tokens=prompts[0]))
    r1 = eng.submit(request(tokens=prompts[1], max_new_tokens=6))
    for _ in range(4):
        eng.step()
    r2 = eng.submit(request(tokens=prompts[2]))   # mid-run: waits for r1's slot
    streams = {r: list(eng.stream(r)) for r in (r0, r1, r2)}
    res = eng.run()
    return [res[r] for r in (r0, r1, r2)], [streams[r] for r in (r0, r1, r2)], eng.pool_stats()


@pytest.fixture(scope="module")
def reference():
    cfg = jconfigs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8)
    params = jregistry.materialize_params(cfg, seed=0)
    out = {"params": jax.device_get(params)}
    with jax.disable_jit():
        for name, kw in LAYOUTS.items():
            scfg = JServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8, **kw)
            eng = JContinuousEngine(cfg, ccfg, scfg, params)
            out[name] = _scenario(eng, JRequest, _prompts(cfg.vocab))
    return out


@pytest.fixture(scope="module")
def port(reference):
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(reference["params"], cfg, device="cpu")

    def engine(batch=2, **kw):
        scfg = ServeConfig(batch_size=batch, prompt_len=48, max_new_tokens=12, page_size=8, **kw)
        return ContinuousEngine(cfg, ccfg, scfg, params, device="cpu")

    runs = {}
    for name, (kw, _) in VARIANTS.items():
        eng = engine(**kw)
        runs[name] = _scenario(eng, Request, _prompts(cfg.vocab))
        runs[name + "/engine"] = eng
    return {"cfg": cfg, "ccfg": ccfg, "params": params, "engine": engine, **runs}


def _tokens(outs):
    return [(o.tokens.tolist(), o.finish_reason) for o in outs]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_tokens_match_reference(reference, port, variant):
    ref_name = VARIANTS[variant][1]
    assert _tokens(port[variant][0]) == _tokens(reference[ref_name][0])
    assert [len(o.tokens) for o in port[variant][0]] == [12, 6, 12]


def test_freelist_defers_and_returns_every_page(reference, port):
    """The small pools defer admissions exactly as the reference's do, and
    every page is back on the free lists at the end."""
    for variant in ("paged-freelist", "paged-kernel"):
        stats = port[variant][2]
        assert stats["deferrals"] >= 1
        assert stats["deferrals"] == reference["paged-freelist"][2]["deferrals"]
        for seg in ("hi", "lo", "win"):
            assert stats[seg]["used"] == 0 and stats[seg]["outstanding"] == 0
            assert stats[seg] == reference["paged-freelist"][2][seg]
        port[variant + "/engine"]._alloc.check_invariants()
    assert port["mixed"][2] is None and port["paged"][2] is None


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stream_concatenates_to_result(port, variant):
    outs, streams, _ = port[variant]
    assert [o.tokens.tolist() for o in outs] == streams


@pytest.mark.parametrize("kw", [LAYOUTS["mixed"], VARIANTS["paged-kernel"][0]],
                         ids=["mixed", "paged-kernel"])
def test_continuous_equals_lockstep(port, kw):
    """Two full-length prompts: the continuous engine's tokens per request
    equal the port's own lockstep `ServingEngine.generate`."""
    prompts = [p for p in _prompts(port["cfg"].vocab) if len(p) == 48][:1] + [
        np.random.default_rng(1).integers(2, port["cfg"].vocab, size=(48,)).astype(np.int32)]
    scfg = ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12)
    want = ServingEngine(port["cfg"], port["ccfg"], scfg, port["params"], device="cpu").generate(
        {"tokens": pack_requests(prompts, 2, 48)})["tokens"]
    eng = port["engine"](**kw)
    rids = [eng.submit(Request(tokens=p)) for p in prompts]
    res = eng.run()
    np.testing.assert_array_equal(np.stack([res[r].tokens for r in rids]), want)


def test_priority_without_preemption_equals_fifo(port):
    """Equal priorities with preemption armed: the priority scheduler never
    fires and degenerates to FIFO bit for bit."""
    eng = port["engine"](backend="paged", page_allocator="freelist", scheduler="priority",
                         preemption="recompute")
    outs, _, stats = _scenario(eng, Request, _prompts(port["cfg"].vocab))
    assert _tokens(outs) == _tokens(port["mixed"][0])
    assert stats["preemptions"] == 0
    assert all(o.timings["n_preemptions"] == 0 for o in outs)


def test_recompute_preemption_keeps_tokens(port):
    """One slot: a running low-priority request past its first fold is evicted
    by an urgent one, re-prefilled and replayed (through a fold) on
    re-admission; both finish with their uncontended tokens."""
    eng = port["engine"](batch=1, backend="paged", page_allocator="freelist",
                         scheduler="priority", preemption="recompute", paged_kernel=True)
    prompts = _prompts(port["cfg"].vocab)
    low = eng.submit(Request(tokens=prompts[0]))
    for _ in range(9):
        eng.step()
    high = eng.submit(Request(tokens=prompts[1], max_new_tokens=6, priority=1))
    events = eng.step()
    assert any(isinstance(e, PreemptedEvent) and e.request_id == low for e in events)
    res = eng.run()
    want = port["mixed"][0]
    assert res[low].tokens.tolist() == want[0].tokens.tolist()
    assert res[high].tokens.tolist() == want[1].tokens.tolist()
    assert res[low].timings["n_preemptions"] == 1
    assert eng.pool_stats()["preemptions"] == 1
    eng._alloc.check_invariants()


def test_cancel_returns_the_slots_pages(port):
    eng = port["engine"](backend="paged", page_allocator="freelist", paged_kernel=True)
    prompts = _prompts(port["cfg"].vocab)
    keep = eng.submit(Request(tokens=prompts[0]))
    victim = eng.submit(Request(tokens=prompts[2]))
    for _ in range(3):
        eng.step()

    def used():
        return sum(v["used"] for k, v in eng.pool_stats().items() if k in ("hi", "lo", "win"))

    before = used()
    assert eng.cancel(victim)
    assert used() < before
    events = eng.step()
    assert any(isinstance(e, CancelledEvent) and e.request_id == victim for e in events)
    res = eng.run()
    assert res[victim].finish_reason == "cancelled" and len(res[victim].tokens) == 4
    assert res[keep].tokens.tolist() == port["mixed"][0][0].tokens.tolist()
    assert used() == 0
    eng._alloc.check_invariants()


def test_serve_cli_continuous_on_cpu(capsys):
    out = serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--continuous",
                      "--requests", "3", "--batch", "2", "--prompt-len", "16", "--max-new", "4",
                      "--backend", "paged", "--page-allocator", "freelist", "--paged-kernel",
                      "on", "--page-size", "8"])
    assert sorted(len(o.tokens) for o in out.values()) == [4, 4, 4]
    printed = capsys.readouterr().out
    assert "page pools peak used" in printed and "kernel launches" in printed


SERVE_LEVERS = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--continuous", "--requests",
                "3", "--batch", "2", "--prompt-len", "16", "--max-new", "4", "--backend",
                "paged", "--page-allocator", "freelist", "--paged-kernel", "on", "--page-size",
                "8", "--scheduler", "priority", "--preemption", "swap", "--swap-pool-mb", "4",
                "--ladder-watermark", "0.05"]


def test_serve_cli_levers_on_cpu(capsys):
    """The lever flags reach the engine: a mapped, swap-armed, ladder-armed
    continuous run serves every request and reports its swap tier."""
    out = serve.main(SERVE_LEVERS + ["--precision-map", "default=k8v8;layer:1-=k3v3"])
    assert sorted(len(o.tokens) for o in out.values()) == [4, 4, 4]
    printed = capsys.readouterr().out
    assert "swap tier: 0 out / 0 in" in printed and "kernel launches" in printed


@pytest.mark.parametrize("argv", [
    ["--precision-map", "layer:0=k0v2"],
    ["--precision-map", "{bad json"],
    ["--swap-pool-mb", "4", "--preemption", "recompute"],
], ids=["bits-out-of-range", "bad-json", "swap-pool-without-swap"])
def test_serve_cli_rejects_bad_levers(argv, capsys):
    """A malformed map (or a swap budget without the swap tier) is an
    argparse error: exit status 2 before any model is built."""
    with pytest.raises(SystemExit) as exc:
        serve.main(SERVE_LEVERS[:-6] + argv)
    assert exc.value.code == 2
    assert "error:" in capsys.readouterr().err


def test_serve_cli_prefix_cache_on_cpu(capsys):
    """--prefix-cache on reaches the engine and prints the prefix line (the
    CLI's prompts are distinct: every admission misses); without the free
    list it is an argparse error."""
    argv = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--continuous", "--requests", "3",
            "--batch", "2", "--prompt-len", "16", "--max-new", "4", "--backend", "paged",
            "--page-size", "8", "--prefix-cache", "on"]
    out = serve.main(argv + ["--page-allocator", "freelist", "--pool-fraction", "1.5"])
    assert sorted(len(o.tokens) for o in out.values()) == [4, 4, 4]
    assert ("prefix cache: 0 hits / 3 misses, 0 CoW copies, 0 prefill tokens skipped"
            in capsys.readouterr().out)
    with pytest.raises(SystemExit) as exc:
        serve.main(argv)
    assert exc.value.code == 2 and "--prefix-cache on requires" in capsys.readouterr().err
