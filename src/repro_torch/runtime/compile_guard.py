"""Capture-counting guard: machine-checks the zero-rebuild invariant of the
port's serving steps (port of `repro.runtime.compile_guard`).

The JAX package jits every engine program once and asserts that steady
serving compiles nothing new.  The port's counterpart of a jitted program
is a decode step over static buffers (`launch.steps`): captured once as a
CUDA graph on the card and replayed, or run eagerly against the same
buffers on the CPU.  A hidden rebuild gives the same tokens, only slower,
so no correctness test sees it.  This module makes it assertable:

    from repro_torch.runtime import compile_guard

    eng.run()                                  # warm-up: builds every step
    with compile_guard.count_captures() as log:
        ... steady-state serving traffic ...
    assert log.count == 0, log.describe()

A step reports each build here by name (`record`): a capture on the card,
or the allocation of its static buffers on the CPU.  Every open log sees
every build in its window, from any thread.

What it can and cannot catch.  A step object builds at most once: it
never drops its graph, and a step whose inputs change shape fails in
`copy_` instead of building again.  So in the port a build inside the
guarded region means that someone made a NEW step object (an engine that
rebuilds its programs, a factory called per request), not that a shape or
a host value forced a retrace as under `jax.jit`; the reference's retrace
test holds more than this one can.  Prefill, the folds and insertion run
eagerly, build nothing and are not counted.  A step that gains a second
graph (a captured probe step) reports that capture here too.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Set

_lock = threading.Lock()
_active: Set["CaptureLog"] = set()


class CaptureLog:
    """Builds observed while a `count_captures()` context is open."""

    def __init__(self) -> None:
        self.count = 0
        self.names: List[str] = []

    def describe(self) -> str:
        if self.count == 0:
            return "0 builds"
        return (f"{self.count} step build(s) inside the guarded region "
                f"({', '.join(self.names)}): a captured step was built again; the decode "
                "loop must replay the steps built at warm-up")


def record(name: str) -> None:
    """One build of the step `name`: counted in every open log."""
    with _lock:
        for log in _active:
            log.count += 1
            log.names.append(name)


@contextlib.contextmanager
def count_captures() -> Iterator[CaptureLog]:
    """Count the step builds in the enclosed region (0 == every step replayed
    what it had built).  Reentrant and thread-safe."""
    log = CaptureLog()
    with _lock:
        _active.add(log)
    try:
        yield log
    finally:
        with _lock:
            _active.discard(log)


class RecaptureError(AssertionError):
    """A guarded region built a step again."""


@contextlib.contextmanager
def assert_no_captures() -> Iterator[CaptureLog]:
    """Raises `RecaptureError`, naming the steps, if anything was built
    inside the region."""
    with count_captures() as log:
        yield log
    if log.count:
        raise RecaptureError(log.describe())
