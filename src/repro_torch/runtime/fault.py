"""Fault tolerance: preemption-safe training loop with checkpoint/restart
(port of `repro.runtime.fault`).

`FaultTolerantLoop` wraps a step function with:
  * periodic async checkpoints (+ data-pipeline state); the last step's
    is blocking, as nothing is left to overlap it with,
  * auto-resume from the latest complete checkpoint,
  * SIGTERM/SIGINT preemption guard → final blocking checkpoint,
  * straggler observation + mitigation hook,
  * failure injection for tests (raise at step N, restart, verify bit-exact
    continuation).
"""

from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import Checkpointer
from repro_torch.runtime.straggler import StragglerDetector


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a polled flag (pod eviction notice)."""

    def __init__(self, install: bool = True):
        self.preempted = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:  # not main thread
                    pass

    def _handler(self, signum, frame):
        self.preempted = True

    def restore(self):
        for sig, h in self._prev.items():
            signal.signal(sig, h)


class FaultTolerantLoop:
    def __init__(
        self,
        step_fn: Callable,                 # (state, batch) -> (state, metrics)
        checkpointer: Checkpointer,
        checkpoint_every: int = 100,
        max_steps: int = 1000,
        straggler: Optional[StragglerDetector] = None,
        on_straggler: Optional[Callable[[Dict], None]] = None,
        fail_at_step: Optional[int] = None,   # failure injection (tests)
        preemption_guard: Optional[PreemptionGuard] = None,
    ):
        self.step_fn = step_fn
        self.ckpt = checkpointer
        self.every = checkpoint_every
        self.max_steps = max_steps
        self.straggler = straggler or StragglerDetector()
        self.on_straggler = on_straggler
        self.fail_at_step = fail_at_step
        self.guard = preemption_guard

    def resume_or(self, init_state: Any, specs=None, mesh=None):
        """(state, start_step, data_state) from the latest checkpoint, else
        init; restored leaves take the dtype and device of init_state's.
        On a mesh (`specs` and `mesh`, or the checkpointer's) each rank
        restores its blocks of the saved leaves."""
        latest = self.ckpt.latest()
        if latest is None:
            return init_state, 0, None
        state, meta = self.ckpt.restore(latest, init_state, specs=specs, mesh=mesh)
        return state, int(meta.get("step", latest)), meta.get("data_state")

    def run(self, state: Any, data_iter, start_step: int = 0,
            metrics_cb: Optional[Callable[[int, Dict], None]] = None):
        """Run until max_steps; returns (state, last_step, history)."""
        history = []
        step = start_step
        while step < self.max_steps:
            if self.guard is not None and self.guard.preempted:
                self.ckpt.save(step, state,
                               {"step": step, "data_state": _ds(data_iter)},
                               blocking=True)
                break
            batch = next(data_iter)
            t0 = time.perf_counter()
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            state, metrics = self.step_fn(state, batch)
            dt = time.perf_counter() - t0
            if self.straggler.observe(step, dt) and self.on_straggler:
                self.on_straggler(self.straggler.events[-1])
            step += 1
            history.append(metrics)
            if metrics_cb:
                metrics_cb(step, metrics)
            if step % self.every == 0:
                # the last step's save has no step left to overlap: it writes
                # straight from the device, with no host snapshot
                self.ckpt.save(step, state,
                               {"step": step, "data_state": _ds(data_iter)},
                               blocking=step == self.max_steps)
        self.ckpt.wait()
        return state, step, history


def _ds(data_iter):
    return data_iter.state() if hasattr(data_iter, "state") else None
