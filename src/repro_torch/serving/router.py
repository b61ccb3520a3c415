"""Multi-replica request router: fan requests across N engine replicas (a
copy of `repro.serving.router`).

One `EngineCore` owns one device footprint (its slots, its page pools).
Scaling past a single replica's slot count means running N engines and
deciding, per request, WHICH one admits it.  `EngineRouter` is that
layer: it duck-types the `EngineCore` request API (`submit` / `cancel` /
`poll` / `result` / `stream` / `step` / `run` / `pending` / `shutdown` /
`pool_stats`) so every driver — the HTTP front, `stream()` consumers —
works unchanged against 1 or N replicas.  Replicas on one card share one
parameter tree and each owns its caches, pools and captured steps; the
router steps them one after the other on the host thread.

Placement
    Least-loaded by default: replicas are ranked by
    ``(busy_slots + queued) / slots`` (occupancy — the first-token-latency
    signal: a queued request waits for a slot), ties broken toward the
    replica with more FREE page-pool pages (`pool_stats()` — the memory
    headroom signal under the free-list allocator), then by replica index
    for determinism.  Pass ``session=`` to `submit` for session affinity:
    the first request of a session picks the least-loaded replica and every
    later request of that session lands on the same one (multi-turn traffic
    keeps any replica-local state — prefix caches, warm pages — hot).

Draining
    `drain(name)` stops routing NEW requests to a replica (its running and
    queued work finishes normally through the existing `shutdown()`
    semantics); sessions pinned to a draining replica are re-pinned on
    their next submit.  `shutdown()` drains every replica.

This module is host-pure by construction: placement is plain-python
bookkeeping over host-side load signals.  It imports no torch, so the
router never launches device work; each replica's `step()` does that.
"""

from __future__ import annotations

import collections
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Set

from repro_torch.serving import events as events_lib


class NoReplicaError(RuntimeError):
    """Every replica is draining (or the router has none): no replica can
    accept the request."""


def _free_pool_pages(stats: Optional[Dict]) -> int:
    """Total free pages across a replica's pools (0 when the replica runs a
    static/mixed layout and has no pool telemetry)."""
    if not stats:
        return 0
    return sum(seg["free"] for seg in stats.values()
               if isinstance(seg, dict) and "free" in seg)


class EngineRouter:
    """Route requests across engine replicas with least-loaded placement.

    replicas: the engines (anything duck-typing `EngineCore`'s request
        API).  The router steps them round-robin-fairly (every `step()`
        call steps EVERY replica with pending work) and merges their event
        streams.
    names: optional display/drain names, default ``replica-<i>``.

    Request ids are globally unique across the router: auto-assigned ids
    are stamped ``<replica-name>/req-<n>`` BEFORE placement, and a
    user-supplied id that any replica has already seen is rejected —
    `poll`/`result`/`stream`/`cancel` then dispatch on the recorded
    placement, so callers never need to know which replica ran what.
    """

    # idle-session pins kept before LRU eviction: bounds `_affinity` under
    # session churn (one-shot sessions used to pin forever — a leak)
    MAX_IDLE_SESSIONS = 1024

    def __init__(self, replicas: Sequence, names: Optional[Sequence[str]] = None,
                 max_idle_sessions: Optional[int] = None):
        if not replicas:
            raise ValueError("EngineRouter needs at least one replica")
        self.replicas: List = list(replicas)
        self.names: List[str] = (list(names) if names is not None
                                 else [f"replica-{i}" for i in range(len(replicas))])
        if len(self.names) != len(self.replicas):
            raise ValueError(
                f"{len(self.names)} names for {len(self.replicas)} replicas")
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"replica names must be unique: {self.names}")
        self._ids = itertools.count()
        self._placement: Dict[str, int] = {}   # request id -> replica index
        # session key -> replica index, LRU-ordered by last submit.  A pin
        # is LIVE while any of the session's requests is queued/running and
        # must never be evicted then (a mid-flight re-pin would split the
        # session across replicas); IDLE pins are kept — multi-turn traffic
        # pauses between turns — but only up to `max_idle_sessions`, oldest
        # evicted first (an evicted session simply re-pins least-loaded on
        # its next submit).
        self._affinity: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self._session_live: Dict[str, Set[str]] = {}  # session -> live rids
        self._req_session: Dict[str, str] = {}        # live rid -> session
        self._max_idle = (self.MAX_IDLE_SESSIONS if max_idle_sessions is None
                          else max_idle_sessions)
        self._draining: List[bool] = [False] * len(self.replicas)

    # ------------------------------------------------------------------
    # load signal + placement
    # ------------------------------------------------------------------

    def load(self, idx: int) -> float:
        """Occupancy of one replica: (busy slots + queued) / slots — the
        share of a slot a NEW request would have to wait for."""
        eng = self.replicas[idx]
        busy = sum(1 for s in eng.slots if s is not None)
        return (busy + len(eng.queue)) / max(len(eng.slots), 1)

    def _pick(self) -> int:
        """Least-loaded live replica: lowest occupancy, then most free
        pool pages, then lowest index (deterministic placement)."""
        live = [i for i in range(len(self.replicas)) if not self._draining[i]]
        if not live:
            raise NoReplicaError(
                "every replica is draining; the router accepts no new work")
        return min(live, key=lambda i: (
            self.load(i),
            -_free_pool_pages(self.replicas[i].pool_stats()),
            i))

    # ------------------------------------------------------------------
    # request API (duck-types EngineCore)
    # ------------------------------------------------------------------

    def submit(self, request, session: Optional[str] = None) -> str:
        """Place + submit a request; returns its (router-global) id.

        session: affinity key — requests sharing it land on the same
        replica (pinned at the session's first submit; re-pinned if that
        replica started draining since)."""
        if request.id is not None and request.id in self._placement:
            raise ValueError(
                f"request id {request.id!r} already submitted to this "
                "router; ids must be unique across replicas")
        if session is not None and session in self._affinity \
                and not self._draining[self._affinity[session]]:
            idx = self._affinity[session]
            self._affinity.move_to_end(session)
        else:
            idx = self._pick()
            if session is not None:
                self._affinity[session] = idx
                self._affinity.move_to_end(session)
        if request.id is None:
            rid = f"{self.names[idx]}/req-{next(self._ids)}"
            while rid in self._placement:   # user ids may shadow auto ids
                rid = f"{self.names[idx]}/req-{next(self._ids)}"
            request.id = rid
        rid = self.replicas[idx].submit(request)
        self._placement[rid] = idx
        if session is not None:
            self._session_live.setdefault(session, set()).add(rid)
            self._req_session[rid] = session
        self._trim_idle_sessions()
        return rid

    def _retire_rid(self, rid: str) -> None:
        """A request finished/cancelled: drop it from its session's live
        set (the session's pin becomes evictable once the set empties)."""
        session = self._req_session.pop(rid, None)
        if session is None:
            return
        live = self._session_live.get(session)
        if live is not None:
            live.discard(rid)
            if not live:
                del self._session_live[session]

    def _session_idle(self, session: str) -> bool:
        """Idle = no queued/running request.  The live sets are maintained
        by `step()`/`cancel()`, but a replica driven directly (e.g. via
        `engine.stream()` generators) retires requests without the router
        seeing the event — so reconcile against `poll` before trusting a
        'live' verdict."""
        live = self._session_live.get(session)
        if not live:
            return True
        for rid in list(live):
            if self.poll(rid) == "done":
                self._retire_rid(rid)
        return session not in self._session_live

    def _trim_idle_sessions(self) -> None:
        """Evict oldest IDLE affinity pins beyond `max_idle_sessions` so
        session churn cannot grow `_affinity` without bound."""
        if len(self._affinity) <= self._max_idle:
            return
        excess = len(self._affinity) - self._max_idle
        for session in list(self._affinity):
            if excess <= 0:
                break
            if self._session_idle(session):
                del self._affinity[session]
                excess -= 1

    def _replica_of(self, request_id: str):
        if request_id not in self._placement:
            raise events_lib.UnknownRequestError(request_id)
        return self.replicas[self._placement[request_id]]

    def cancel(self, request_id: str, reason: str = "client") -> bool:
        done = self._replica_of(request_id).cancel(request_id, reason=reason)
        if done:
            self._retire_rid(request_id)
        return done

    def poll(self, request_id: str) -> str:
        return self._replica_of(request_id).poll(request_id)

    def result(self, request_id: str):
        return self._replica_of(request_id).result(request_id)

    def stream(self, request_id: str) -> Iterator[int]:
        return self._replica_of(request_id).stream(request_id)

    # ------------------------------------------------------------------
    # drive + lifecycle
    # ------------------------------------------------------------------

    @property
    def pending(self) -> bool:
        return any(eng.pending for eng in self.replicas)

    def step(self) -> List[events_lib.Event]:
        """One iteration of every replica with pending work, events merged
        in replica order (each replica's own event order is preserved)."""
        events: List[events_lib.Event] = []
        for eng in self.replicas:
            if eng.pending:
                events.extend(eng.step())
        for ev in events:
            if isinstance(ev, (events_lib.FinishedEvent,
                               events_lib.CancelledEvent)):
                self._retire_rid(ev.request_id)
        return events

    def run(self, max_steps: Optional[int] = None) -> Dict:
        """Drive every replica until all submitted requests finished;
        returns the merged id -> RequestOutput dict."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        merged: Dict = {}
        for eng in self.replicas:
            merged.update(eng.results)
        return merged

    def drain(self, name: str) -> None:
        """Stop routing new work to one replica (graceful: its queued and
        running requests finish normally; its `submit()` starts raising
        `events.EngineClosedError` via the engine's own `shutdown()`)."""
        idx = self.names.index(name)
        self._draining[idx] = True
        self.replicas[idx].shutdown()

    def shutdown(self) -> None:
        """Drain every replica: the router (and each engine) accepts no
        new work but finishes what it has."""
        for name in self.names:
            if not self._draining[self.names.index(name)]:
                self.drain(name)

    def pool_stats(self) -> Dict[str, Optional[Dict]]:
        """Per-replica pool telemetry, keyed by replica name (each value is
        that engine's `pool_stats()` — None for static/mixed layouts)."""
        return {name: eng.pool_stats()
                for name, eng in zip(self.names, self.replicas)}

    def stats(self) -> Dict[str, Dict]:
        """Router-level load snapshot per replica: occupancy, busy slots,
        queue depth, free pool pages, draining flag — the same signals
        placement ranks on, exposed for dashboards and tests."""
        out: Dict[str, Dict] = {}
        for i, (name, eng) in enumerate(zip(self.names, self.replicas)):
            out[name] = {
                "load": self.load(i),
                "busy_slots": sum(1 for s in eng.slots if s is not None),
                "queued": len(eng.queue),
                "slots": len(eng.slots),
                "free_pool_pages": _free_pool_pages(eng.pool_stats()),
                "draining": self._draining[i],
            }
        return out
