"""Typed event stream + typed API errors for the serving engine (a copy of
`repro.serving.events`).

`EngineCore.step()` returns the list of events that iteration produced, in
order.  Seven event kinds cover the request lifecycle after admission:

  * ``TokenEvent``     — one freshly decoded token (``index`` is its position
    in the request's output stream; the first token, sampled from the
    prefill logits at admission, is index 0).  Replayed tokens during
    preempt+recompute re-admission are NOT re-emitted: they were already
    delivered when first decoded, and recompute reproduces them exactly.
  * ``PreemptedEvent`` — the request's slot was evicted (its pages returned
    to the free pools, its ``n_generated`` tokens retained host-side); the
    request is back in the queue and will be re-admitted by recompute.
  * ``FinishedEvent``  — the request retired; ``result(id)`` is available.
  * ``CancelledEvent`` — the request was retired early by
    ``EngineCore.cancel`` (a client disconnect, an expired
    ``Request.deadline_s``, or an explicit API call): its slot is freed,
    its pages returned, and ``result(id)`` carries the tokens decoded so
    far with ``finish_reason="cancelled"``.  Terminal, in place of (never
    in addition to) a `FinishedEvent`.
  * ``DownshiftEvent``  — the pressure ladder early-folded the request's
    staging window at a lowered lo-store effective bit-width (``rung`` is
    the slot's new ladder rung; ``pages_freed`` the window pages that came
    back to the pool).  The request keeps decoding — a downshift trades
    precision for memory instead of evicting (``preemption="downshift"``)
    or deferring admissions (``ServeConfig.ladder_watermark``).
  * ``SwappedEvent``    — the request's exact quantized cache crossed the
    host boundary (``direction="out"``: pages returned to the pool, state
    mirrored into the host swap tier; ``direction="in"``: state uploaded
    and re-granted pages rewritten — no prefill, no recompute).  A
    swapped-then-restored request decodes bitwise as if never evicted;
    like recompute replay, nothing is re-emitted on restore.
  * ``CallbackErrorEvent`` — a `Request.on_token` callback raised.  The
    engine contains the exception (``step()`` stays transactional — slot
    counters, fold cadence, and tokens are untouched), detaches the
    callback so a broken sink cannot raise twice, and surfaces the error
    here instead of unwinding the step.

Events raised between steps (``cancel()`` from an async server loop) are
buffered and returned by the NEXT ``step()`` call, never dropped.

Consumers: ``engine.stream(request_id)`` (a generator yielding tokens as
they decode — it drives ``step()`` itself when its buffer runs dry),
``Request.on_token`` (a per-request callback invoked with each TokenEvent),
or direct iteration over ``step()``'s return value.

The errors make misuse typed instead of leaking dict internals:
``UnknownRequestError`` subclasses ``KeyError`` (old-style handlers keep
working) and ``EngineClosedError`` signals ``submit()`` after
``shutdown()``.
"""

from __future__ import annotations

import dataclasses


class UnknownRequestError(KeyError):
    """``poll``/``result``/``stream`` on a request id this engine has never
    seen (never submitted, or submitted to another engine)."""

    def __init__(self, request_id: str):
        super().__init__(request_id)
        self.request_id = request_id

    def __str__(self) -> str:  # KeyError quotes its arg; keep the hint
        return (f"unknown request id {self.request_id!r}: never submitted "
                "to this engine")


class EngineClosedError(RuntimeError):
    """``submit()`` after ``shutdown()``: the engine drains what it has but
    accepts no new work."""


@dataclasses.dataclass(frozen=True)
class Event:
    """Base: which request, at which scheduler step the event fired."""
    request_id: str
    step: int


@dataclasses.dataclass(frozen=True)
class TokenEvent(Event):
    token: int
    index: int          # position in the request's output stream (0-based)


@dataclasses.dataclass(frozen=True)
class PreemptedEvent(Event):
    n_generated: int    # tokens retained host-side for recompute


@dataclasses.dataclass(frozen=True)
class FinishedEvent(Event):
    finish_reason: str  # "stop" | "length"
    n_tokens: int


@dataclasses.dataclass(frozen=True)
class CancelledEvent(Event):
    n_tokens: int       # tokens decoded (and already delivered) before cancel
    reason: str         # "client" | "deadline" | caller-supplied


@dataclasses.dataclass(frozen=True)
class DownshiftEvent(Event):
    rung: int           # the slot's ladder rung AFTER this downshift
    pages_freed: int    # window pages the early fold returned to the pool


@dataclasses.dataclass(frozen=True)
class SwappedEvent(Event):
    direction: str      # "out" (evicted to host) | "in" (restored, no recompute)
    n_generated: int    # tokens decoded so far (retained host-side with the cache)
    host_bytes: int     # resident bytes in the swap pool AFTER this transfer


@dataclasses.dataclass(frozen=True)
class CallbackErrorEvent(Event):
    error: str          # "<ExceptionType>: <message>" from the raised callback
