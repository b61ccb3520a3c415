"""Pluggable admission/preemption policies for the continuous-batching engine
(a copy of `repro.serving.scheduler`).

The engine-core/scheduler split: `serving.engine.EngineCore` owns the
mechanism (step functions, slots, page allocator, event plumbing) and asks
an injected `Scheduler` three policy questions each step:

  * ``admit(queue, free_slots, pool)`` — which queued requests go into which
    free slots right now (an `AdmissionPlan`); the scheduler must consult
    ``pool.fits``/``pool.reserve`` so a plan of several admissions accounts
    for the pages each one will reserve (the engine executes admissions
    sequentially, and sequential page headroom drops by exactly the
    worst-case reservation per admission — `PoolView` mirrors that).
  * ``select_victim(queue, running, pool)`` — when preemption is enabled and
    requests are still waiting after admission: which running slot (if any)
    to evict so a more urgent request can run.  The engine handles the
    mechanics (return the victim's pages, retain its tokens host-side,
    requeue it, re-admit by recompute).
  * ``on_retire(slot_id, request)`` — notification hook for stateful
    policies (fairness accounting, aging); built-ins need no state here.

`FIFOScheduler` reproduces the pre-split `ContinuousEngine` admission
behavior bitwise: strict queue order, first free slot in ascending id
order, head-of-line blocking when the page pool cannot cover the head's
worst case (no later request jumps the queue), never a victim.

`PriorityScheduler` orders the queue by (priority desc, arrival seq) and
preempts vLLM-style: when the most urgent waiting request outranks a
running one, the lowest-priority running slot (ties: largest remaining
budget, then lowest slot id) is evicted and later re-admitted by
recompute.  Equal priorities never preempt each other, so the policy
cannot thrash between peers; with every priority equal it degenerates to
FIFO and is token-identical to `FIFOScheduler`.  Queued requests AGE:
every `aging_steps` scheduler steps spent waiting raises a request's
effective priority by one class, so strict priority cannot starve the
FIFO tail (see the class docstring).
"""

from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

if TYPE_CHECKING:  # engine imports the schedulers; avoid the runtime cycle
    from repro_torch.serving.engine import Request


@dataclasses.dataclass(frozen=True)
class SlotView:
    """What schedulers see of one RUNNING slot (no engine internals).
    `budget` is the ENGINE-resolved decode budget (the per-request cap or
    the ServeConfig default when the request left it unset), so
    `remaining_budget` is exact for every request."""
    slot_id: int
    request: Request
    n_generated: int
    budget: int

    @property
    def remaining_budget(self) -> int:
        return self.budget - self.n_generated


@dataclasses.dataclass
class AdmissionPlan:
    """`admissions` are executed in order: (free slot id, queued request).
    `blocked` is the most urgent request the page pool could NOT cover —
    the engine turns it into a counted deferral or, with
    ``backpressure="error"``, a typed `PagePoolExhausted`."""
    admissions: List[Tuple[int, Request]] = dataclasses.field(default_factory=list)
    blocked: Optional[Request] = None


class PoolView:
    """Admission-control view over the engine's page pools.

    ``fits(request)`` answers "can the pools reserve this request's worst
    case right now", counting the reservations this PLAN already made via
    ``reserve`` — which makes a multi-admission plan equivalent to the
    engine's sequential admit-then-recheck loop (each real admission
    lowers every segment's headroom by exactly the worst-case reservation).
    Mixed/static layouts have no allocator: everything fits.
    """

    def __init__(self, alloc, demand_fn):
        self._alloc = alloc                      # FreeListAllocator | None
        # Request -> {segment: worst pages}.  The engine owns the demand
        # model: it folds in ragged admission buckets and shared-prefix
        # aliasing (a planned hit whose pages already exist reserves fewer
        # pages than a cold miss), so the view just consumes the dict.
        self._demand = demand_fn
        self._pending: Dict[str, int] = {}

    def _worst(self, request: Request) -> Dict[str, int]:
        return self._demand(request)

    def fits(self, request: Request) -> bool:
        if self._alloc is None:
            return True
        worst = self._worst(request)
        head = self._alloc.admit_headroom()
        return all(head[n] - self._pending.get(n, 0) >= worst[n]
                   for n in worst)

    def reserve(self, request: Request) -> None:
        """Record a planned admission's worst-case demand against this view."""
        if self._alloc is None:
            return
        for n, w in self._worst(request).items():
            self._pending[n] = self._pending.get(n, 0) + w

    def stats(self):
        return None if self._alloc is None else self._alloc.stats()


@runtime_checkable
class Scheduler(Protocol):
    def admit(self, queue: Sequence[Request], free_slots: Sequence[int],
              pool: PoolView) -> AdmissionPlan: ...

    def select_victim(self, queue: Sequence[Request],
                      running: Sequence[SlotView],
                      pool: PoolView) -> Optional[int]: ...

    def on_retire(self, slot_id: int, request: Request) -> None: ...


def _arrival(request: Request) -> int:
    # stamped by EngineCore.submit; 0 for requests planned outside an engine
    return getattr(request, "_seq", 0)


class FIFOScheduler:
    """Strict submission order; bitwise-identical to the pre-split engine."""

    def admit(self, queue, free_slots, pool) -> AdmissionPlan:
        plan = AdmissionPlan()
        qi = 0
        for slot_id in free_slots:
            if qi >= len(queue):
                break
            req = queue[qi]
            if not pool.fits(req):
                plan.blocked = req      # head-of-line: nobody jumps the queue
                break
            pool.reserve(req)
            plan.admissions.append((slot_id, req))
            qi += 1
        return plan

    def select_victim(self, queue, running, pool) -> Optional[int]:
        return None                     # FIFO never evicts a running slot

    def on_retire(self, slot_id, request) -> None:
        pass


class PriorityScheduler:
    """Highest `Request.priority` first (FIFO within a priority class), with
    vLLM-style preempt+recompute of strictly lower-priority running slots.

    AGING: strict priority alone can starve — a steady stream of priority-1
    arrivals would park a priority-0 request in the queue forever.  Each
    `admit()` call a request spends queued bumps its wait counter; its
    EFFECTIVE priority is `priority + waits // aging_steps`, so after
    `aging_steps` scheduler steps it competes one class up, after 2x two
    classes up, and so on — every request eventually outranks fresh
    arrivals.  Ordering within the queue and victim selection both use the
    effective value (running slots keep their static priority: they are
    making progress, not waiting).  The default of 64 steps is far above
    the conformance scenarios' horizon, so existing priority traces are
    bitwise unchanged; `aging_steps=0` disables aging outright."""

    def __init__(self, aging_steps: int = 64):
        self.aging_steps = int(aging_steps)
        self._waits: Dict[str, int] = {}   # request id -> admit() calls queued

    def _effective(self, request: Request) -> int:
        if not self.aging_steps:
            return request.priority
        return request.priority + self._waits.get(request.id, 0) // self.aging_steps

    def _order(self, queue: Sequence[Request]) -> List[Request]:
        return sorted(queue, key=lambda r: (-self._effective(r), _arrival(r)))

    def _age(self, queue: Sequence[Request]) -> None:
        """One admit() round passed with these requests still queued: bump
        their wait counters and drop state for ids no longer waiting (the
        counter restarts if a request is admitted and later preempted —
        it is no longer starving once it has run)."""
        live = {r.id for r in queue if r.id is not None}
        for rid in [k for k in self._waits if k not in live]:
            del self._waits[rid]
        for rid in live:
            self._waits[rid] = self._waits.get(rid, 0) + 1

    def admit(self, queue, free_slots, pool) -> AdmissionPlan:
        self._age(queue)
        plan = AdmissionPlan()
        candidates = self._order(queue)
        qi = 0
        for slot_id in free_slots:
            if qi >= len(candidates):
                break
            req = candidates[qi]
            if not pool.fits(req):
                # stop at the most urgent request that does not fit: admitting
                # a less urgent one instead would starve it (same head-of-line
                # discipline as FIFO, in priority order)
                plan.blocked = req
                break
            pool.reserve(req)
            plan.admissions.append((slot_id, req))
            qi += 1
        return plan

    def select_victim(self, queue, running, pool) -> Optional[int]:
        if not queue or not running:
            return None
        head = self._order(queue)[0]
        victims = [s for s in running
                   if s.request.priority < self._effective(head)]
        if not victims:
            return None                 # equal priorities never preempt: no thrash
        # lowest priority first; among those, the one monopolizing the most
        # remaining budget (bounding head-of-line latency is the point);
        # lowest slot id breaks exact ties deterministically
        victims.sort(key=lambda s: (s.request.priority, -s.remaining_budget,
                                    s.slot_id))
        return victims[0].slot_id

    def on_retire(self, slot_id, request) -> None:
        pass


SCHEDULERS = {"fifo": FIFOScheduler, "priority": PriorityScheduler}


def make_scheduler(name: str) -> Scheduler:
    if name not in SCHEDULERS:
        raise ValueError(
            f"unknown scheduler {name!r}; choose from {sorted(SCHEDULERS)}")
    return SCHEDULERS[name]()
