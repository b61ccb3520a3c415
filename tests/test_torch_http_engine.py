"""Port parity for the serving edge over a real engine and real sockets: the
port's `HttpFrontend` in front of the port's `ContinuousEngine` (on the
CPU, the kernels' plain versions) at tests/test_http.py's configuration
(yi-6b smoke, zipcache at fp_window = recompress_interval = 8, 2 slots,
prompt window 32, budget 48, paged free list, page 8), with the JAX
package's parameters carried over by `repro_torch.convert`.

  * SSE tokens equal the done event's tokens, `result(rid).tokens`, and the
    JAX `ContinuousEngine`'s tokens for the same greedy request and for a
    sampled one (temperature 0.7, seed 3);
  * the JSON response, 400, 404 and 503 (a shut-down engine, an all-drained
    router), `/health`;
  * a hang-up cancels the request and returns its pages, and a hang-up
    mid-batch stages the slot inactive and leaves the other row's tokens;
    a deadline and the cancel endpoint terminate the stream with
    "cancelled";
  * the router over two port replicas: requests spread, tokens equal the
    single engine's, per-replica stats;
  * `/v1/stats`, the done event and the JSON body carry the reference
    front's keys (the port's `pool_stats()` adds two counters, named);
  * `python -m repro_torch.launch.serve_http --device cpu` as a process:
    the printed port, a streamed request, SIGINT, the kernel-launch line,
    exit status 0.

The JAX engine runs once, jitted, for the module; its tokens are cached.
"""

import asyncio
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core.policy import CompressionConfig as JCompression
from repro.models import registry as jregistry
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import EngineRouter as JEngineRouter
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServeConfig as JServeConfig
from repro.serving.http import HttpFrontend as JHttpFrontend
from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.launch import serve_http
from repro_torch.launch.steps import ROW_ACT
from repro_torch.serving import (ContinuousEngine, EngineRouter, Request, SamplingParams,
                                 ServeConfig)
from repro_torch.serving.http import HttpFrontend
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
ROOT = Path(__file__).resolve().parents[1]
SCFG = dict(batch_size=2, prompt_len=32, max_new_tokens=48, backend="paged", page_size=8,
            page_allocator="freelist")
# (prompt seed, budget, temperature, seed): one greedy request, one sampled
REQUESTS = {"greedy": (0, 8, 0.0, 0), "sampled": (5, 8, 0.7, 3)}
# the port's pool_stats() counters beyond the reference's
PORT_POOL_KEYS = {"admissions", "folds"}


def _prompt(vocab, seed=0, n=24):
    return np.random.default_rng(seed).integers(2, vocab, size=(n,)).tolist()


def _spec(vocab, name, **kw):
    pseed, budget, temp, seed = REQUESTS[name]
    return {"tokens": _prompt(vocab, pseed), "max_new_tokens": budget, "temperature": temp,
            "seed": seed, **kw}


async def _open_post(port, path, payload):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode()
    writer.write((f"POST {path} HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    return reader, writer


async def _read_headers(reader):
    status = (await reader.readline()).decode()
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    return status


async def _read_sse(reader):
    tokens, final = [], None
    while final is None:
        line = (await reader.readline()).strip()
        if not line:
            continue
        if line.startswith(b"data: "):
            d = json.loads(line[6:])
            if "token" in d:
                tokens.append(d["token"])
            else:
                final = d
    return tokens, final


async def _request_json(port, method, path, payload=None):
    if payload is None:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
        await writer.drain()
    else:
        reader, writer = await _open_post(port, path, payload)
    status = await _read_headers(reader)
    body = json.loads(await reader.read())
    writer.close()
    return status, body


async def _generate(port, spec):
    reader, writer = await _open_post(port, "/v1/generate", spec)
    status = await _read_headers(reader)
    tokens, final = await _read_sse(reader)
    writer.close()
    return status, tokens, final


def _with_front(front_cls, engine, coro):
    """Run `coro(front)` under a live server; never drains the engine (the
    module engine is shared across tests)."""
    async def run():
        front = front_cls(engine, port=0)
        await front.start()
        try:
            return await coro(front)
        finally:
            await front.stop(drain=False)
    return asyncio.run(run())


def _keys(tree):
    """Nested key set of a JSON object, as sorted paths."""
    if not isinstance(tree, dict):
        return []
    return sorted([k] + [f"{k}.{sub}" for sub in _keys(v)] for k, v in tree.items())


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's tokens for `REQUESTS`, run together in one engine;
    the JAX front's /v1/stats body over a router of that engine; the JAX
    params for the port."""
    cfg = jconfigs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8)
    params = jregistry.materialize_params(cfg, 0)
    eng = JContinuousEngine(cfg, ccfg, JServeConfig(**SCFG), params)
    with jax.threefry_partitionable(True):
        rids = {}
        for name, (pseed, budget, temp, seed) in REQUESTS.items():
            rids[name] = eng.submit(JRequest(
                tokens=np.asarray(_prompt(cfg.vocab, pseed), np.int32), max_new_tokens=budget,
                sampling=JSamplingParams(temperature=temp, seed=seed)))
        res = eng.run()

    async def stats(front):
        return await _request_json(front.port, "GET", "/v1/stats")

    _, body = _with_front(JHttpFrontend, JEngineRouter([eng, eng], names=["a", "b"]), stats)
    return {"tokens": {n: res[r].tokens.tolist() for n, r in rids.items()},
            "timings": set(res[rids["greedy"]].timings), "stats": body,
            "params": jax.device_get(params)}


@pytest.fixture(scope="module")
def model(reference):
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(reference["params"], cfg, device="cpu")

    def make():
        return ContinuousEngine(cfg, ccfg, ServeConfig(**SCFG), params, device="cpu")

    return cfg, make


@pytest.fixture(scope="module")
def engine(model):
    cfg, make = model
    return cfg, make()


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_http_sse_tokens_equal_result_and_reference(engine, reference, name):
    cfg, eng = engine

    async def scenario(front):
        return await _generate(front.port, _spec(cfg.vocab, name))

    status, tokens, final = _with_front(HttpFrontend, eng, scenario)
    out = eng.result(final["id"])
    assert "200" in status
    assert tokens == final["tokens"] == out.tokens.tolist()
    assert final["finish_reason"] == out.finish_reason == "length"
    assert tokens == reference["tokens"][name]
    assert set(final) == {"id", "finish_reason", "tokens", "timings"}
    assert set(final["timings"]) == reference["timings"]


def test_http_nonstream_json_and_statuses(engine, reference):
    cfg, eng = engine

    async def scenario(front):
        ok = await _request_json(front.port, "POST", "/v1/generate",
                                 _spec(cfg.vocab, "sampled", stream=False))
        bad = await _request_json(front.port, "POST", "/v1/generate", {"wrong": 1})
        bad_json = await _request_json(front.port, "POST", "/v1/cancel", {"rid": 1})
        lost = await _request_json(front.port, "GET", "/nope")
        health = await _request_json(front.port, "GET", "/health")
        stats = await _request_json(front.port, "GET", "/v1/stats")
        return ok, bad, bad_json, lost, health, stats

    ok, bad, bad_json, lost, health, stats = _with_front(HttpFrontend, eng, scenario)
    assert "200" in ok[0] and ok[1]["tokens"] == reference["tokens"]["sampled"]
    assert eng.result(ok[1]["id"]).tokens.tolist() == ok[1]["tokens"]
    assert "400" in bad[0] and "tokens" in bad[1]["error"]
    assert "400" in bad_json[0]
    assert "404" in lost[0]
    assert health[1] == {"ok": True}
    assert "200" in stats[0] and set(stats[1]) == {"pool_stats"}
    ref_pool = next(iter(reference["stats"]["pool_stats"].values()))
    assert set(stats[1]["pool_stats"]) == set(ref_pool) | PORT_POOL_KEYS
    assert _keys({k: v for k, v in stats[1]["pool_stats"].items()
                  if k not in PORT_POOL_KEYS}) == _keys(ref_pool)


def test_http_503_when_closed(model):
    """A shut-down engine rejects with 503 and the error's type."""
    cfg, make = model
    eng = make()
    eng.shutdown()

    async def scenario(front):
        return await _request_json(front.port, "POST", "/v1/generate",
                                   _spec(cfg.vocab, "greedy"))

    status, body = _with_front(HttpFrontend, eng, scenario)
    assert "503" in status and body["error"].startswith("EngineClosedError")


def _pages_used(eng):
    return {k: v["used"] for k, v in eng.pool_stats().items()
            if isinstance(v, dict) and "used" in v}


def test_http_disconnect_cancels_and_returns_pages(engine):
    """Hanging up an SSE connection cancels the request at the engine: slot
    freed, pages back, before the budget runs out."""
    cfg, eng = engine
    assert not any(_pages_used(eng).values())

    async def scenario(front):
        reader, writer = await _open_post(front.port, "/v1/generate",
                                          {"tokens": _prompt(cfg.vocab, 2)})
        await _read_headers(reader)
        first = (await reader.readline()).strip()
        assert first.startswith(b"data: ")
        known = set(eng.results)
        writer.close()
        for _ in range(400):
            await asyncio.sleep(0.01)
            new = [r for r in eng.results if r not in known]
            if new:
                return new[0]
        raise AssertionError("the hang-up never cancelled the request")

    rid = _with_front(HttpFrontend, eng, scenario)
    out = eng.result(rid)
    assert out.finish_reason == "cancelled"
    assert 1 <= len(out.tokens) < 48
    assert not any(_pages_used(eng).values())
    eng._alloc.check_invariants()


def test_http_hang_up_mid_batch_leaves_the_other_row(engine, reference):
    """A hang-up between two steps of a batch: the hung-up request's slot
    is staged inactive in the steps after it, and the other request's
    tokens stay the JAX engine's."""
    cfg, eng = engine
    prompt_b = _prompt(cfg.vocab, 6)

    async def scenario(front):
        reader, writer = await _open_post(front.port, "/v1/generate", {"tokens": prompt_b})
        await _read_headers(reader)
        assert (await reader.readline()).startswith(b"data: ")
        slot_b = next(i for i, sl in enumerate(eng.slots)
                      if sl is not None and sl.request.tokens.tolist() == prompt_b)
        rid_b = eng.slots[slot_b].request.id
        a = asyncio.create_task(_generate(front.port, _spec(cfg.vocab, "sampled")))
        while sum(sl is not None for sl in eng.slots) < 2:   # A admitted beside B
            await asyncio.sleep(0)
        writer.close()
        return await a, slot_b, rid_b

    (_, tokens, final), slot_b, rid_b = _with_front(HttpFrontend, eng, scenario)
    out_b = eng.result(rid_b)
    assert out_b.finish_reason == "cancelled" and len(out_b.tokens) < 48
    assert tokens == final["tokens"] == reference["tokens"]["sampled"]
    active = eng._decode_masked.staged[ROW_ACT].tolist()   # A's last step
    assert active[slot_b] == 0 and active[1 - slot_b] == 1
    assert not any(_pages_used(eng).values())


def test_http_deadline_cancels(engine):
    cfg, eng = engine

    async def scenario(front):
        return await _generate(front.port, {"tokens": _prompt(cfg.vocab, 3),
                                            "deadline_s": 1e-4})

    _, _, final = _with_front(HttpFrontend, eng, scenario)
    assert final["finish_reason"] == "cancelled"
    assert eng.result(final["id"]).finish_reason == "cancelled"
    assert not any(_pages_used(eng).values())


def test_http_cancel_endpoint(engine):
    cfg, eng = engine

    async def scenario(front):
        reader, writer = await _open_post(front.port, "/v1/generate",
                                          {"tokens": _prompt(cfg.vocab, 4)})
        await _read_headers(reader)
        await reader.readline()
        live = sorted(set(eng._known) - set(eng.results))
        assert len(live) == 1
        cancel = await _request_json(front.port, "POST", "/v1/cancel", {"id": live[0]})
        again = await _request_json(front.port, "POST", "/v1/cancel", {"id": live[0]})
        unknown = await _request_json(front.port, "POST", "/v1/cancel", {"id": "ghost"})
        _, final = await _read_sse(reader)
        writer.close()
        return cancel, again, unknown, final

    cancel, again, unknown, final = _with_front(HttpFrontend, eng, scenario)
    assert "200" in cancel[0] and cancel[1]["cancelled"] is True
    assert "200" in again[0] and again[1]["cancelled"] is False
    assert "404" in unknown[0]
    assert final["finish_reason"] == "cancelled"


def test_http_router_two_replicas_end_to_end(engine, model, reference):
    """Two port replicas behind the router: concurrent requests spread by
    load, each stream equals its replica's result and the single engine's
    tokens; stats per replica with the reference's keys; an all-drained
    router answers 503."""
    cfg, eng = engine
    _, make = model
    router = EngineRouter([eng, make()], names=["warm", "cold"])

    async def scenario(front):
        results = await asyncio.gather(*[_generate(front.port, _spec(cfg.vocab, name))
                                         for name in ("greedy", "sampled", "greedy")])
        stats = await _request_json(front.port, "GET", "/v1/stats")
        return results, stats

    results, stats = _with_front(HttpFrontend, router, scenario)
    placed = set()
    for (_, tokens, final), name in zip(results, ("greedy", "sampled", "greedy")):
        assert tokens == final["tokens"] == router.result(final["id"]).tokens.tolist()
        assert tokens == reference["tokens"][name]
        placed.add(final["id"].split("/")[0])
    assert placed == {"warm", "cold"}
    assert set(stats[1]) == set(reference["stats"]) == {"pool_stats", "replicas"}
    assert set(stats[1]["replicas"]) == set(stats[1]["pool_stats"]) == {"warm", "cold"}
    ref_rep = next(iter(reference["stats"]["replicas"].values()))
    for rep in stats[1]["replicas"].values():
        assert set(rep) == set(ref_rep)
        assert rep["busy_slots"] == rep["queued"] == 0
        assert rep["free_pool_pages"] == sum(v["pool_pages"] for v in
                                             eng.pool_stats().values()
                                             if isinstance(v, dict) and "pool_pages" in v)

    drained = EngineRouter([make()], names=["only"])
    drained.drain("only")

    async def rejected(front):
        return await _request_json(front.port, "POST", "/v1/generate",
                                   _spec(cfg.vocab, "greedy"))

    status, body = _with_front(HttpFrontend, drained, rejected)
    assert "503" in status and body["error"].startswith("NoReplicaError")


SERVE_HTTP_ARGV = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--batch", "2",
                   "--prompt-len", "32", "--max-new", "48", "--backend", "paged", "--page-size",
                   "8", "--page-allocator", "freelist", "--replicas", "2", "--port", "0"]


def _serve_http_args(monkeypatch):
    """`serve_http.main`'s parsed and validated args for `SERVE_HTTP_ARGV`."""

    class _Parsed(Exception):
        pass

    def capture(args):
        raise _Parsed(args)

    monkeypatch.setattr(serve_http, "build_frontend", capture)
    with pytest.raises(_Parsed) as exc:
        serve_http.main(SERVE_HTTP_ARGV)
    monkeypatch.undo()
    return exc.value.args[0]


def test_serve_http_process_streams_and_exits_on_sigint(monkeypatch):
    """The entry point as a process on the CPU: two replicas, one streamed
    sampled request equal to the same request through `build_frontend`'s
    router in this process (the CLI's --smoke cadence is 16), then SIGINT:
    drained, the launch line printed (plain versions launch nothing), exit
    status 0."""
    args = _serve_http_args(monkeypatch)
    front = serve_http.build_frontend(args)
    assert isinstance(front.engine, EngineRouter) and len(front.engine.replicas) == 2
    assert front.engine.replicas[0].params is front.engine.replicas[1].params
    assert front.engine.replicas[0].ccfg.fp_window == 16
    vocab = configs.get_arch("yi-6b", smoke=True).vocab
    pseed, budget, temp, seed = REQUESTS["sampled"]
    rid = front.engine.submit(Request(tokens=np.asarray(_prompt(vocab, pseed), np.int32),
                                      max_new_tokens=budget,
                                      sampling=SamplingParams(temperature=temp, seed=seed)))
    want = front.engine.run()[rid].tokens.tolist()

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve_http",
                             *SERVE_HTTP_ARGV], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on http://127\.0\.0\.1:(\d+) \(2 replica", line)
        assert m, line + proc.stderr.read()
        status, tokens, final = asyncio.run(_generate(int(m.group(1)),
                                                      _spec(vocab, "sampled")))
        assert "200" in status and tokens == final["tokens"] == want
        assert final["id"] == "replica-0/req-0"
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    launches = re.search(r"\[serve_http\] kernel launches: (\{.*\})", out)
    assert launches and set(json.loads(launches.group(1).replace("'", '"'))) == {
        "cst_quant", "flash_fwd", "probe_colsum", "decode_qattn", "paged_qattn"}
