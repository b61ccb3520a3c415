"""Straggler detection: EWMA z-score over per-step (or per-host) latencies
(a copy of `repro.runtime.straggler`).

At pod scale a slow chip/host throttles every synchronous collective.  The
detector keeps an exponentially-weighted mean/variance of step times and
flags outliers; the driver's mitigation hook then (a) logs + alerts, (b) in a
real deployment triggers hot-spare swap / job re-mesh (simulated in tests via
the elastic re-mesh helper).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.1          # EWMA factor
    z_threshold: float = 4.0    # flag if step_time > mean + z * std
    warmup: int = 8             # ignore the first N steps (compile, cache)

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    events: List[Dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float, host: Optional[int] = None) -> bool:
        """Record a step latency; returns True if flagged as straggling."""
        self._n += 1
        if self._n <= self.warmup:
            # prime statistics without flagging
            self._mean = dt if self._n == 1 else (1 - self.alpha) * self._mean + self.alpha * dt
            self._var = max(self._var, (dt - self._mean) ** 2)
            return False
        std = max(self._var ** 0.5, 1e-9)
        flagged = dt > self._mean + self.z_threshold * std
        if flagged:
            self.events.append({"step": step, "dt": dt, "mean": self._mean,
                                "std": std, "host": host})
        # update stats with clipped dt so one straggler doesn't poison the EWMA
        upd = min(dt, self._mean + 2 * std)
        delta = upd - self._mean
        self._mean += self.alpha * delta
        self._var = (1 - self.alpha) * (self._var + self.alpha * delta * delta)
        return flagged

    @property
    def mean(self) -> float:
        return self._mean
