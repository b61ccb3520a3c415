"""Port parity for the serving edge, host side: `Backoff`, the HTTP front's
drive loop, the multi-replica `EngineRouter`, and the launch surface
(`repro_torch.launch.serve` / `serve_http`), against the JAX package.

  * tests/test_http.py's `Backoff`, drive-loop and router cases, each run
    over the reference classes and the port's on the same stub engines and
    fake replicas (no device, no engine); the port's drive loop also
    cancels a hung-up stream before the next step, and each step's token
    events reach the client before the next step;
  * a seeded random sequence of submits (with and without sessions), load
    changes, drains, cancels and retirements through both routers side by
    side: placements, ids, errors and `stats()` equal step for step;
  * the serve CLIs: the same argv through both packages' parsers builds
    equal `CompressionConfig` and `ServeConfig` fields, and the argparse
    guards of tests/test_http.py exit with status 2 in the port's `serve`
    and `serve_http` too.

Nothing here needs JAX to compute: the reference runs as plain Python.
"""

import argparse
import asyncio
import collections
import dataclasses
import types

import numpy as np
import pytest

from repro import serving as jserving
from repro.launch import serve as jserve
from repro.serving import http as jhttp
from repro_torch import serving as tserving
from repro_torch.launch import serve, serve_http
from repro_torch.serving import http as thttp
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

IMPLS = {
    name: types.SimpleNamespace(
        Backoff=h.Backoff, HttpFrontend=h.HttpFrontend, EngineRouter=s.EngineRouter,
        NoReplicaError=s.NoReplicaError, UnknownRequestError=s.UnknownRequestError,
        Request=s.Request, TokenEvent=s.TokenEvent, FinishedEvent=s.FinishedEvent)
    for name, h, s in (("reference", jhttp, jserving), ("port", thttp, tserving))}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


# ---------------------------------------------------------------------------
# Backoff + drive loop (stub engine)
# ---------------------------------------------------------------------------

def test_backoff_grows_caps_and_resets(impl):
    b = impl.Backoff(initial=0.01, maximum=0.05, factor=2.0)
    assert [b.next_delay() for _ in range(4)] == [0.01, 0.02, 0.04, 0.05]
    assert b.next_delay() == 0.05          # capped
    b.reset()
    assert b.next_delay() == 0.01


@pytest.mark.parametrize("bad", [dict(initial=0.0), dict(maximum=0.0001), dict(factor=0.5)])
def test_backoff_rejects_nonsense(impl, bad):
    with pytest.raises(ValueError):
        impl.Backoff(**bad)


def test_backoff_sequences_equal_reference():
    """Delays for every (initial, maximum, factor) of a small grid, with a
    reset midway: the same floats from both classes."""
    for initial in (0.001, 0.01, 0.03):
        for maximum in (initial, 0.05, 0.2):
            for factor in (1.0, 1.5, 2.0, 3.0):
                seqs = []
                for impl in IMPLS.values():
                    b = impl.Backoff(initial=initial, maximum=maximum, factor=factor)
                    seq = [b.next_delay() for _ in range(7)]
                    b.reset()
                    seqs.append(seq + [b.next_delay() for _ in range(3)])
                assert seqs[0] == seqs[1]


class _StubEngine:
    """Minimal engine double for the drive loop: scripted step() returns."""

    def __init__(self, script=None):
        self.script = list(script or [])
        self.steps = 0
        self.pending = True

    def step(self):
        self.steps += 1
        return self.script.pop(0) if self.script else []

    def shutdown(self):
        self.pending = False


def _recording(impl, **kw):
    class _RecordingBackoff(impl.Backoff):
        def __init__(self):
            super().__init__(**kw)
            self.delays = []
            self.resets = 0

        def next_delay(self):
            d = super().next_delay()
            self.delays.append(d)
            return d

        def reset(self):
            self.resets += 1
            super().reset()

    return _RecordingBackoff()


def test_drive_loop_backs_off_on_empty_steps(impl):
    """A pending engine whose steps return no events is not busy-stepped:
    the loop sleeps between steps with growing delays, the same series as
    the reference's."""
    stub = _StubEngine()
    bo = _recording(impl, initial=0.01, maximum=0.04)
    front = impl.HttpFrontend(stub, backoff=bo)

    async def run():
        task = asyncio.create_task(front._drive())
        await asyncio.sleep(0.15)
        front._closed = True
        front._wake.set()
        await task

    asyncio.run(run())
    assert 2 <= stub.steps <= 20, stub.steps
    assert bo.delays == [min(0.01 * 2 ** i, 0.04) for i in range(len(bo.delays))]


def test_drive_once_dispatches_and_resets_backoff(impl):
    """Productive steps route events to the registered per-request queues
    and reset the idle backoff; events of unregistered requests are dropped."""
    ev = impl.TokenEvent("r1", 0, token=7, index=0)
    other = impl.TokenEvent("r2", 0, token=9, index=0)
    stub = _StubEngine(script=[[ev, other], []])
    bo = _recording(impl, initial=0.01, maximum=0.04)
    front = impl.HttpFrontend(stub, backoff=bo)

    async def run():
        q = asyncio.Queue()
        front._queues["r1"] = q
        assert front._drive_once() is True
        assert bo.resets == 1
        assert q.get_nowait() is ev
        assert q.empty()
        assert front._drive_once() is False
        assert bo.resets == 1

    asyncio.run(run())


def test_drive_once_cancels_hung_up_streams_before_the_step():
    """The port's front: before each engine step, every open SSE stream
    whose client has hung up (its reader at EOF, or reset) is cancelled, so
    the step decodes nothing for it; open streams are left alone."""
    calls = []

    class Engine(_StubEngine):
        def cancel(self, rid, reason="client"):
            calls.append(("cancel", rid, reason))
            return True

        def step(self):
            calls.append(("step",))
            return super().step()

    front = thttp.HttpFrontend(Engine())

    async def run():
        gone, reset, live = (asyncio.StreamReader() for _ in range(3))
        gone.feed_eof()
        reset.set_exception(ConnectionResetError())
        front._streams.update(gone=gone, reset=reset, live=live)
        front._drive_once()

    asyncio.run(run())
    assert calls == [("cancel", "gone", "client"), ("cancel", "reset", "client"), ("step",)]


def test_sse_events_leave_before_the_next_step():
    """The port's front writes each step's token events to the client before
    the drive loop runs the next step.  (The reference's handler spends a
    task and a wait on every event, several loop iterations, while its
    drive loop steps once per iteration, so its streams fall behind.)"""

    class Writer:
        def __init__(self):
            self.chunks = []

        def write(self, data):
            self.chunks.append(data)

        async def drain(self):
            pass

    writer, written = Writer(), []

    class Engine(_StubEngine):
        def step(self):
            written.append(len(writer.chunks) - 1)   # token events out before this step
            self.steps += 1
            if self.steps <= 5:
                return [tserving.TokenEvent("r", self.steps, token=7, index=self.steps - 1)]
            self.pending = False
            return [tserving.FinishedEvent("r", self.steps, finish_reason="length",
                                           n_tokens=5)]

        def result(self, rid):
            return types.SimpleNamespace(id=rid, finish_reason="length", tokens=[7] * 5,
                                         timings={})

    front = thttp.HttpFrontend(Engine())

    async def run():
        queue = asyncio.Queue()
        front._queues["r"] = queue
        handler = asyncio.create_task(
            front._stream_sse("r", queue, asyncio.StreamReader(), writer))
        drive = asyncio.create_task(front._drive())
        await asyncio.wait_for(handler, timeout=5)
        front._closed = True
        front._wake.set()
        await drive

    asyncio.run(run())
    assert written == [0, 1, 2, 3, 4, 5]
    assert len(writer.chunks) == 1 + 5 + 1 and b"event: done" in writer.chunks[-1]


def test_drive_loop_parks_when_idle(impl):
    """Nothing pending: the loop never calls step(), and a stop() while
    parked returns within one backoff maximum."""
    stub = _StubEngine()
    stub.pending = False
    front = impl.HttpFrontend(stub, backoff=impl.Backoff(initial=0.01, maximum=0.02))

    async def run():
        task = asyncio.create_task(front._drive())
        await asyncio.sleep(0.08)
        front._closed = True
        front._wake.set()
        await asyncio.wait_for(task, timeout=1.0)

    asyncio.run(run())
    assert stub.steps == 0


# ---------------------------------------------------------------------------
# EngineRouter placement (fake replicas)
# ---------------------------------------------------------------------------

class _FakeReplica:
    def __init__(self, slots=2, busy=0, queued=0, free_pages=0):
        self.slots = [object() if i < busy else None for i in range(slots)]
        self.queue = collections.deque(range(queued))
        self.results = {}
        self.submitted = []
        self.free_pages = free_pages
        self.closed = False
        self.to_finish = []

    def submit(self, request):
        if request.id is None:
            request.id = f"fake-{len(self.submitted)}"
        self.submitted.append(request.id)
        return request.id

    def cancel(self, rid, reason="client"):
        self.cancelled = (rid, reason)
        return True

    def poll(self, rid):
        return "done" if rid in self.results else "running"

    def pool_stats(self):
        if self.free_pages == 0:
            return None
        return {"hi": {"free": self.free_pages}, "lo": {"free": self.free_pages // 2},
                "deferrals": 0}

    def shutdown(self):
        self.closed = True

    @property
    def pending(self):
        return bool(self.to_finish)

    def step(self):
        evs = [self._finished(r) for r in self.to_finish]
        self.to_finish = []
        return evs


def _replica_for(impl):
    class Replica(_FakeReplica):
        def _finished(self, rid):
            return impl.FinishedEvent(request_id=rid, step=0, finish_reason="stop",
                                      n_tokens=1)
    return Replica


def _req(impl, rid=None):
    return impl.Request(tokens=np.asarray([1, 2, 3], np.int32), id=rid)


def test_router_places_least_loaded(impl):
    R = _replica_for(impl)
    a = R(slots=2, busy=2, queued=1)     # load 1.5
    b = R(slots=2, busy=1)               # load 0.5
    router = impl.EngineRouter([a, b], names=["a", "b"])
    rid = router.submit(_req(impl))
    assert b.submitted and not a.submitted
    assert rid.startswith("b/")
    assert router._placement[rid] == 1


def test_router_breaks_ties_toward_free_pages_then_index(impl):
    R = _replica_for(impl)
    a, b = R(slots=2, busy=1, free_pages=2), R(slots=2, busy=1, free_pages=9)
    impl.EngineRouter([a, b]).submit(_req(impl))
    assert b.submitted and not a.submitted          # same load, more pages
    c, d = R(slots=2), R(slots=2)
    impl.EngineRouter([c, d]).submit(_req(impl))
    assert c.submitted and not d.submitted          # full tie: lowest index


def test_router_session_affinity_sticks_and_repins_on_drain(impl):
    R = _replica_for(impl)
    a, b = R(slots=2, busy=2, queued=3), R(slots=2)
    router = impl.EngineRouter([a, b], names=["a", "b"])
    r1 = router.submit(_req(impl), session="s1")   # lands on b (least loaded)
    assert b.submitted == [r1]
    b.slots = [object(), object()]                  # b now the busier one
    b.queue.extend(range(4))
    r2 = router.submit(_req(impl), session="s1")   # affinity beats load
    assert b.submitted == [r1, r2] and not a.submitted
    router.drain("b")
    assert b.closed
    r3 = router.submit(_req(impl), session="s1")   # re-pinned off the drained one
    assert a.submitted == [r3]
    router.drain("a")
    with pytest.raises(impl.NoReplicaError):
        router.submit(_req(impl))


def test_router_rejects_duplicate_ids_and_unknown_rids(impl):
    R = _replica_for(impl)
    router = impl.EngineRouter([R(), R()])
    router.submit(_req(impl, "dup"))
    with pytest.raises(ValueError):
        router.submit(_req(impl, "dup"))
    with pytest.raises(impl.UnknownRequestError):
        router.poll("never-seen")
    with pytest.raises(impl.UnknownRequestError):
        router.cancel("never-seen")


def test_router_cancel_routes_to_placement(impl):
    R = _replica_for(impl)
    a, b = R(busy=2), R()
    router = impl.EngineRouter([a, b])
    rid = router.submit(_req(impl))                 # b: lower load
    assert router.cancel(rid, reason="deadline") is True
    assert b.cancelled == (rid, "deadline")


def test_router_affinity_map_bounded_under_session_churn(impl):
    """Idle pins beyond `max_idle_sessions` are LRU-evicted; live pins never
    are, whatever the cap; an idle pin below the cap survives."""
    R = _replica_for(impl)
    a, b = R(), R()
    router = impl.EngineRouter([a, b], names=["a", "b"], max_idle_sessions=8)
    for i in range(100):
        rid = router.submit(_req(impl), session=f"churn-{i}")
        (a if rid in a.submitted else b).results[rid] = object()
    assert len(router._affinity) <= 8 + 1, len(router._affinity)
    assert len(router._session_live) <= 8 + 1
    assert len(router._req_session) <= 8 + 1

    c, d = R(), R()
    live = impl.EngineRouter([c, d], max_idle_sessions=2)
    rids = [live.submit(_req(impl), session=f"live-{i}") for i in range(5)]
    assert all(f"live-{i}" in live._affinity for i in range(5))
    c.results[rids[0]] = d.results[rids[0]] = object()
    pin = live._affinity["live-0"]
    live.submit(_req(impl), session="live-0")
    assert live._affinity["live-0"] == pin


def test_router_retires_sessions_on_finish_and_cancel_events(impl):
    eng = _replica_for(impl)()
    router = impl.EngineRouter([eng])
    r1 = router.submit(_req(impl), session="s")
    r2 = router.submit(_req(impl), session="s")
    assert router._session_live["s"] == {r1, r2}
    eng.to_finish = [r1]
    router.step()
    assert router._session_live["s"] == {r2}
    assert router.cancel(r2)
    assert "s" not in router._session_live and not router._req_session


def test_router_validates_construction(impl):
    R = _replica_for(impl)
    with pytest.raises(ValueError):
        impl.EngineRouter([])
    with pytest.raises(ValueError):
        impl.EngineRouter([R()], names=["a", "b"])
    with pytest.raises(ValueError):
        impl.EngineRouter([R(), R()], names=["a", "a"])


def _router_trace(impl, seed: int):
    """A seeded random run of one router over three fake replicas: what each
    operation returned or raised, and `stats()` after it."""
    rng = np.random.default_rng(seed)
    R = _replica_for(impl)
    reps = [R(slots=int(rng.integers(1, 4)), free_pages=int(rng.integers(0, 6)))
            for _ in range(3)]
    router = impl.EngineRouter(reps, names=["x", "y", "z"], max_idle_sessions=3)
    trace, rids = [], []
    for _ in range(120):
        op = rng.choice(["submit", "session", "load", "finish", "cancel", "named", "drain"],
                        p=[0.25, 0.25, 0.2, 0.12, 0.08, 0.06, 0.04])
        try:
            if op in ("submit", "session", "named"):
                rid = (f"user-{int(rng.integers(0, 8))}" if op == "named" else None)
                session = f"s{int(rng.integers(0, 6))}" if op == "session" else None
                got = router.submit(_req(impl, rid), session=session)
                rids.append(got)
                out = ("placed", got, router._placement[got])
            elif op == "load":
                r = reps[int(rng.integers(0, 3))]
                busy = int(rng.integers(0, len(r.slots) + 1))
                r.slots = [object() if i < busy else None for i in range(len(r.slots))]
                r.queue = collections.deque(range(int(rng.integers(0, 3))))
                r.free_pages = int(rng.integers(0, 6))
                out = ("load",)
            elif op == "finish" and rids:
                rid = rids[int(rng.integers(0, len(rids)))]
                rep = reps[router._placement[rid]]
                rep.results[rid] = object()
                rep.to_finish.append(rid)
                out = ("events", [e.request_id for e in router.step()])
            elif op == "cancel":
                rid = rids[int(rng.integers(0, len(rids)))] if rids and rng.random() < 0.8 \
                    else "ghost"
                out = ("cancel", router.cancel(rid, reason="client"))
            elif op == "drain":
                name = ["x", "y", "z"][int(rng.integers(0, 3))]
                router.drain(name)
                out = ("drain", name)
            else:
                out = ("noop",)
        except (ValueError, impl.NoReplicaError, impl.UnknownRequestError) as e:
            out = ("raised", type(e).__name__, str(e))
        trace.append((out, router.stats(), sorted(router._affinity.items())))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_router_equals_reference_on_random_traffic(seed):
    ref, port = (_router_trace(IMPLS[k], seed) for k in ("reference", "port"))
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"operation {i}: reference {a} != port {b}"
    assert any(t[0][0] == "raised" for t in ref) and any(t[0][0] == "placed" for t in ref)


# ---------------------------------------------------------------------------
# the serve CLIs
# ---------------------------------------------------------------------------

CONFIG_ARGV = {
    "defaults": [],
    "smoke": ["--smoke"],
    "mikv": ["--policy", "mikv", "--saliency-ratio", "0.3"],
    "mikv-smoke": ["--smoke", "--policy", "mikv"],
    "zipcache-ratio-smoke": ["--smoke", "--saliency-ratio", "0.25", "--batch", "3",
                             "--prompt-len", "48", "--max-new", "12", "--seed", "5"],
    "paged": ["--backend", "paged", "--page-size", "16", "--paged-kernel", "on"],
    "freelist-smoke": ["--smoke", "--backend", "paged", "--page-allocator", "freelist",
                       "--pool-fraction", "0.75", "--admit-watermark", "0.1",
                       "--prefix-cache", "on"],
    "levers": ["--backend", "paged", "--page-allocator", "freelist", "--paged-kernel", "on",
               "--scheduler", "priority", "--preemption", "swap", "--swap-pool-mb", "4",
               "--ladder-watermark", "0.05", "--precision-map", "default=k8v8;layer:1-=k3v3"],
}


def _parse(module, argv):
    ap = argparse.ArgumentParser()
    module.add_engine_args(ap)
    args = ap.parse_args(["--arch", "yi-6b", *argv])
    module.validate_engine_args(args, ap, continuous=True)
    return args


@pytest.mark.parametrize("argv", CONFIG_ARGV.values(), ids=CONFIG_ARGV.keys())
def test_serve_configs_equal_reference(argv):
    """The same flags build the same compression and serve configs in both
    packages (--smoke: fp_window = recompress_interval = 16)."""
    ja, ta = _parse(jserve, argv), _parse(serve, argv)
    jc, tc = jserve.build_compression_config(ja), serve.build_compression_config(ta)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (tc.fp_window, tc.recompress_interval) == ((16, 16) if "--smoke" in argv
                                                      else (128, 100))
    js, ts = jserve.build_serve_config(ja), serve.build_serve_config(ta)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)


@pytest.mark.parametrize("argv", [
    ["--arch", "yi-6b", "--pool-fraction", "0.5"],
    ["--arch", "yi-6b", "--admit-watermark", "0.25"],
    ["--arch", "yi-6b", "--continuous", "--backend", "paged", "--pool-fraction", "0.5"],
    ["--arch", "yi-6b", "--paged-kernel", "on"],
    ["--arch", "yi-6b", "--preemption", "recompute"],
])
def test_serve_rejects_silently_ignored_flags(argv):
    with pytest.raises(SystemExit) as exc:
        serve.main(argv)
    assert exc.value.code == 2


def test_serve_requests_requires_continuous(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "yi-6b", "--requests", "3"])
    assert exc.value.code == 2 and "--requests requires --continuous" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--arch", "yi-6b", "--pool-fraction", "0.5"],
    ["--arch", "yi-6b", "--replicas", "0"],
    ["--arch", "yi-6b", "--scheduler", "priority", "--preemption", "recompute",
     "--paged-kernel", "on"],
])
def test_serve_http_rejects_invalid_combos(argv):
    with pytest.raises(SystemExit) as exc:
        serve_http.main(argv)
    assert exc.value.code == 2


def test_serve_http_accepts_continuous_only_combos(monkeypatch):
    """The HTTP front is always continuous: flags gated on --continuous in
    the batch driver validate here.  The front's builder is stubbed out
    before any engine is built."""

    class _Stop(Exception):
        pass

    captured = {}

    def no_engine(args):
        captured["args"] = args
        raise _Stop

    monkeypatch.setattr(serve_http, "build_frontend", no_engine)
    with pytest.raises(_Stop):
        serve_http.main(["--arch", "yi-6b", "--smoke", "--backend", "paged",
                         "--page-allocator", "freelist", "--pool-fraction", "0.5",
                         "--scheduler", "priority", "--preemption", "recompute"])
    assert captured["args"].pool_fraction == 0.5
    assert captured["args"].replicas == 1
    assert captured["args"].device == "cuda"
