"""Asyncio HTTP/SSE serving front over `EngineCore` (or `EngineRouter`) (a
port of `repro.serving.http`).

The network edge: requests arrive over POST, tokens stream back as
server-sent events, client disconnects cancel the request
(`EngineCore.cancel` — slot freed, pages returned), and per-request
deadlines ride `Request.deadline_s` into the engine's own sweep.  Stdlib
only (asyncio streams + a minimal HTTP/1.1 parser): the container bakes no
HTTP framework, and the surface we need — POST + SSE + Connection: close —
is small enough that a dependency would cost more than it saves.

Endpoints
    POST /v1/generate   JSON body: {"tokens": [ints], "max_new_tokens"?,
                        "temperature"?, "seed"?, "stop_tokens"?,
                        "priority"?, "deadline_s"?, "session"?,
                        "stream"?: bool (default true)}.
                        stream=true  -> ``text/event-stream``: one
                        ``data: {"token": t, "index": i}`` event per
                        decoded token, then a terminal
                        ``event: done`` / ``data: {... "tokens": [...]}``
                        whose token list is bitwise `result(rid).tokens`
                        (the per-token events concatenate to exactly it).
                        stream=false -> one JSON response when finished.
    POST /v1/cancel     {"id": rid} -> {"cancelled": bool}.
    GET  /v1/stats      engine/router load + pool telemetry as JSON.
    GET  /health        liveness probe.

Drive loop
    One background coroutine owns ``engine.step()`` — called synchronously
    on the event loop thread, never in an executor: the engine mutates host
    state like the admission deque, which the handlers' ``submit`` calls
    read, and a step captures and replays CUDA graphs on the stream of the
    thread that built them.  Handlers communicate with it through
    per-request asyncio queues fed from the step's returned events.  When steps come back EMPTY (every queued
    request deferred by the page pools, or nothing pending) the loop backs
    off exponentially (`Backoff`) instead of busy-driving ``step()`` the
    way the synchronous ``stream()`` helper may; a fresh submit wakes it
    immediately (``_wake``).

Cancellation
    While an SSE response is open the drive loop watches its client
    socket: before every step, EOF or a reset (the client hung up) cancels
    the request at the engine — the typed `CancelledEvent` path — so a
    disconnected client's slot and pages are reclaimed before the next
    step instead of leaking for the full decode budget.  An expired
    `deadline_s` takes the same path with reason "deadline" and terminates
    the SSE stream with ``finish_reason="cancelled"``.

Where this differs from the reference
    The reference watches each socket from a task of the stream's own, and
    its handler spends a task and an `asyncio.wait` on every event (three
    or more loop iterations) while the drive loop steps once per
    iteration, so its streams fall behind the engine (by seconds on an
    H100 at yi-6b's full width).  Here a handler waits on its event queue alone and is woken in
    the iteration after the step that fed it, before the next step.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
from typing import Dict, Optional

import numpy as np

from repro_torch.serving import engine as engine_lib
from repro_torch.serving import events as events_lib

# terminal events: the request left the engine, result(rid) is available
_TERMINAL = (events_lib.FinishedEvent, events_lib.CancelledEvent)


class Backoff:
    """Exponential idle backoff for the drive loop: empty-event steps sleep
    ``initial * factor^k`` capped at ``maximum``; any productive step
    resets.  Deterministic and loop-free so tests can drive it directly."""

    def __init__(self, initial: float = 0.001, maximum: float = 0.05,
                 factor: float = 2.0):
        if not (initial > 0 and maximum >= initial and factor >= 1.0):
            raise ValueError(
                f"need 0 < initial <= maximum and factor >= 1, got "
                f"({initial}, {maximum}, {factor})")
        self.initial, self.maximum, self.factor = initial, maximum, factor
        self._cur = initial

    def next_delay(self) -> float:
        """The delay to sleep NOW; grows the next one."""
        d = self._cur
        self._cur = min(self._cur * self.factor, self.maximum)
        return d

    def reset(self) -> None:
        self._cur = self.initial


def _json_response(status: str, payload) -> bytes:
    body = json.dumps(payload).encode()
    return (f"HTTP/1.1 {status}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode() + body


_SSE_HEADER = (b"HTTP/1.1 200 OK\r\n"
               b"Content-Type: text/event-stream\r\n"
               b"Cache-Control: no-cache\r\n"
               b"Connection: close\r\n\r\n")


def _sse(payload, event: Optional[str] = None) -> bytes:
    head = f"event: {event}\n" if event else ""
    return f"{head}data: {json.dumps(payload)}\n\n".encode()


class HttpFrontend:
    """HTTP/SSE edge around one engine (or an `EngineRouter` — the request
    API is duck-typed, so 1 replica and N replicas serve identically).

    Lifecycle::

        front = HttpFrontend(engine, host="127.0.0.1", port=0)
        await front.start()          # port=0 -> front.port has the real one
        ...
        await front.stop()           # drain=True: engine.shutdown() + drain

    ``stop(drain=False)`` detaches without closing the engine — the same
    engine instance can serve again (tests reuse one engine across server
    sessions so its captured steps stay built).
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 backoff: Optional[Backoff] = None):
        self.engine = engine
        self.host, self.port = host, port
        self.backoff = backoff if backoff is not None else Backoff()
        self._queues: Dict[str, asyncio.Queue] = {}
        self._streams: Dict[str, asyncio.StreamReader] = {}   # open SSE responses
        self._wake = asyncio.Event()
        self._server: Optional[asyncio.AbstractServer] = None
        self._drive_task: Optional[asyncio.Task] = None
        self._closed = False

    # ------------------------------------------------------------------
    # drive loop: the ONLY caller of engine.step() while the front is up
    # ------------------------------------------------------------------

    def _drive_once(self) -> bool:
        """One engine step; route its events to the waiting handlers.
        Returns True if the step produced any events (progress)."""
        for rid, reader in list(self._streams.items()):
            # SSE clients never send again: EOF or a reset is a hang-up
            if reader.at_eof() or reader.exception() is not None:
                self._cancel_quietly(rid, "client")
        events = self.engine.step()
        for ev in events:
            q = self._queues.get(ev.request_id)
            if q is not None:
                q.put_nowait(ev)
        if events:
            self.backoff.reset()
            return True
        return False

    async def _drive(self) -> None:
        while not self._closed:
            if not self.engine.pending:
                # idle: park until a submit wakes us (re-check periodically
                # so a stop() or an externally-submitted request isn't
                # stranded behind a cleared flag)
                self._wake.clear()
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(self._wake.wait(),
                                           timeout=self.backoff.maximum)
                continue
            if self._drive_once():
                await asyncio.sleep(0)      # yield: let handlers flush SSE
            else:
                # pending but no events: every queued request is deferred
                # (page-pool pressure) — back off instead of spinning the
                # scheduler at CPU speed
                await asyncio.sleep(self.backoff.next_delay())

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._drive_task = asyncio.create_task(self._drive())

    async def stop(self, drain: bool = True) -> None:
        """Stop serving.  drain=True also closes the engine (`shutdown()`)
        and steps it until every accepted request finished; drain=False
        detaches and leaves the engine open for reuse."""
        self._closed = True
        self._wake.set()
        if self._drive_task is not None:
            await self._drive_task
            self._drive_task = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if drain:
            self.engine.shutdown()
            while self.engine.pending:
                self._drive_once()

    # ------------------------------------------------------------------
    # HTTP plumbing
    # ------------------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await reader.readline()
            if not request_line:
                return
            try:
                method, target, _ = request_line.decode().split(None, 2)
            except ValueError:
                writer.write(_json_response(
                    "400 Bad Request", {"error": "malformed request line"}))
                return
            headers: Dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                key, _, val = line.decode().partition(":")
                headers[key.strip().lower()] = val.strip()
            body = b""
            length = int(headers.get("content-length", "0") or 0)
            if length:
                body = await reader.readexactly(length)
            await self._route(method, target, body, reader, writer)
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass        # client went away mid-parse/mid-write
        finally:
            with contextlib.suppress(Exception):
                writer.close()

    async def _route(self, method: str, target: str, body: bytes,
                     reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        if method == "GET" and target == "/health":
            writer.write(_json_response("200 OK", {"ok": True}))
            await writer.drain()
        elif method == "GET" and target == "/v1/stats":
            stats = {"pool_stats": self.engine.pool_stats()}
            router_stats = getattr(self.engine, "stats", None)
            if callable(router_stats):
                stats["replicas"] = router_stats()
            writer.write(_json_response("200 OK", stats))
            await writer.drain()
        elif method == "POST" and target == "/v1/cancel":
            await self._handle_cancel(body, writer)
        elif method == "POST" and target == "/v1/generate":
            await self._handle_generate(body, reader, writer)
        else:
            writer.write(_json_response(
                "404 Not Found", {"error": f"no route {method} {target}"}))
            await writer.drain()

    async def _handle_cancel(self, body: bytes,
                             writer: asyncio.StreamWriter) -> None:
        try:
            rid = json.loads(body.decode() or "{}")["id"]
            cancelled = self.engine.cancel(rid)
        except events_lib.UnknownRequestError as e:
            writer.write(_json_response("404 Not Found", {"error": str(e)}))
        except (json.JSONDecodeError, KeyError):
            writer.write(_json_response(
                "400 Bad Request", {"error": 'body must be {"id": <rid>}'}))
        else:
            writer.write(_json_response("200 OK", {"cancelled": cancelled}))
        await writer.drain()

    def _build_request(self, spec: Dict) -> engine_lib.Request:
        return engine_lib.Request(
            tokens=np.asarray(spec["tokens"], np.int32),
            max_new_tokens=spec.get("max_new_tokens"),
            stop_tokens=tuple(spec.get("stop_tokens", ())),
            priority=int(spec.get("priority", 0)),
            deadline_s=spec.get("deadline_s"),
            sampling=engine_lib.SamplingParams(
                temperature=float(spec.get("temperature", 0.0)),
                seed=int(spec.get("seed", 0))))

    def _submit(self, req: engine_lib.Request, session: Optional[str]) -> str:
        if session is not None:
            # only the router places by session; a bare engine has no
            # affinity concept and takes the request as-is
            try:
                return self.engine.submit(req, session=session)
            except TypeError:
                pass
        return self.engine.submit(req)

    async def _handle_generate(self, body: bytes,
                               reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter) -> None:
        try:
            spec = json.loads(body.decode())
            if not isinstance(spec, dict) or "tokens" not in spec:
                raise ValueError('body must be a JSON object with "tokens"')
            req = self._build_request(spec)
            rid = self._submit(req, spec.get("session"))
        except (json.JSONDecodeError, ValueError, TypeError, KeyError) as e:
            writer.write(_json_response("400 Bad Request", {"error": str(e)}))
            await writer.drain()
            return
        except Exception as e:
            # EngineClosedError / NoReplicaError / PoolCapacityError: the
            # request was REJECTED, not failed — tell the client to go away
            writer.write(_json_response(
                "503 Service Unavailable",
                {"error": f"{type(e).__name__}: {e}"}))
            await writer.drain()
            return
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[rid] = queue
        self._wake.set()
        try:
            if spec.get("stream", True):
                await self._stream_sse(rid, queue, reader, writer)
            else:
                await self._respond_json(rid, queue, writer)
        finally:
            self._queues.pop(rid, None)

    def _final_payload(self, rid: str) -> Dict:
        out = self.engine.result(rid)
        return {"id": out.id,
                "finish_reason": out.finish_reason,
                "tokens": [int(t) for t in out.tokens],
                "timings": out.timings}

    async def _respond_json(self, rid: str, queue: asyncio.Queue,
                            writer: asyncio.StreamWriter) -> None:
        while True:
            ev = await queue.get()
            if isinstance(ev, _TERMINAL):
                break
        writer.write(_json_response("200 OK", self._final_payload(rid)))
        await writer.drain()

    async def _stream_sse(self, rid: str, queue: asyncio.Queue,
                          reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        writer.write(_SSE_HEADER)
        await writer.drain()
        # the client hanging up is our cancellation signal: the drive loop
        # watches `reader` for it (`_drive_once`), and the cancellation's
        # event ends this loop like any terminal event
        self._streams[rid] = reader
        try:
            while True:
                ev = await queue.get()
                if isinstance(ev, events_lib.TokenEvent):
                    try:
                        writer.write(_sse(
                            {"token": ev.token, "index": ev.index}))
                        await writer.drain()
                    except (ConnectionResetError, BrokenPipeError):
                        self._cancel_quietly(rid, "client")
                        return
                elif isinstance(ev, _TERMINAL):
                    with contextlib.suppress(
                            ConnectionResetError, BrokenPipeError):
                        writer.write(_sse(self._final_payload(rid),
                                          event="done"))
                        await writer.drain()
                    return
                # CallbackErrorEvent / PreemptedEvent etc. are engine-side
                # diagnostics, not stream content — the SSE contract is
                # "token events concatenate to result().tokens"
        finally:
            self._streams.pop(rid, None)

    def _cancel_quietly(self, rid: str, reason: str) -> None:
        """Cancel on disconnect: the request may have finished in the same
        step the client vanished — that race is fine, cancel() returns
        False for done requests and unknown ids cannot happen here."""
        self.engine.cancel(rid, reason=reason)
