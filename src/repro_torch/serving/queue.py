"""Admission queue: priority classes with FIFO order inside each class,
a hard depth bound, and SLO-aware load shedding (copy of
``repro/serving/queue.py``).

Pure host-side bookkeeping — nothing here touches a device.  The queue
stamps each request's enqueue time (and absolute deadline, when the
request carries an ``slo_ms``) so the engine can attribute queueing
delay separately from service time, and keeps an optional depth bound so
overload turns into *shed* load instead of unbounded memory.

Two shedding policies govern what happens when the bound is hit:

* ``'reject-newest'`` (default): the incoming request is turned away —
  classic tail drop, FIFO fairness, no reordering.
* ``'deadline-aware'``: the queued entry with the *earliest* absolute
  deadline (the one most likely to miss its SLO anyway) is evicted in
  favor of an incoming request with more slack; an arrival with less
  slack than everything queued is rejected instead.  Entries without an
  SLO have an infinite deadline and are never evicted.  Entries are
  stamped with their deadline under EVERY policy, and the engine calls
  ``expire()`` before admission whenever any queued entry carries one
  (``has_deadlines``) — so a request whose deadline already passed
  while queued is dropped rather than occupying a denoising slot it can
  only waste, regardless of the shed policy at the depth bound.

Shed accounting is split by cause: ``rejected`` (arrivals turned away at
the bound), ``evicted`` (queued entries displaced by deadline-aware
shedding) and ``expired`` (entries whose deadline passed while queued);
``shed`` is their sum.  ``on_shed`` (constructor arg or assignable
attribute) is the per-request observability hook: it fires as
``on_shed(reason, request, now)`` for every shed, with the SPECIFIC
request that was dropped — the engine wires it into its metrics and
tracer so a shed is attributable to a request id, not just a counter.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, List, Optional, Tuple, Union

from repro_torch.serving.api import GenerationRequest

#: Valid ``shed_policy`` values.
SHED_POLICIES = ('reject-newest', 'deadline-aware')


@dataclasses.dataclass(frozen=True)
class Queued:
    """A request plus its admission bookkeeping.  ``deadline`` is the
    absolute serving-clock time by which the request must finish
    (``enqueue_time + slo_ms/1e3``; +inf when the request has no SLO)."""
    request: GenerationRequest
    enqueue_time: float
    deadline: float = math.inf


class AdmissionQueue:
    def __init__(self, max_depth: Optional[int] = None,
                 shed_policy: str = 'reject-newest',
                 on_shed: Optional[Callable[
                     [str, GenerationRequest, float], None]] = None):
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f'unknown shed_policy {shed_policy!r} '
                             f'(expected one of {SHED_POLICIES})')
        self.max_depth = max_depth
        self.shed_policy = shed_policy
        self.on_shed = on_shed        # (reason, request, now) per shed
        self._heap: List[Tuple[int, int, Queued]] = []
        self._seq = 0                 # FIFO tiebreak within a priority
        self.submitted = 0
        self.rejected = 0             # arrivals turned away at the bound
        self.evicted = 0              # queued entries displaced (deadline)
        self.expired = 0              # deadline passed while queued

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def shed(self) -> int:
        """Total requests shed, across all causes."""
        return self.rejected + self.evicted + self.expired

    @property
    def has_deadlines(self) -> bool:
        """True when any queued entry carries a finite deadline.  The
        engine keys expiry on THIS, not on the shed policy: a request
        with an ``slo_ms`` must be expired even under ``reject-newest``
        or an unbounded queue — otherwise it can sit past its deadline
        and still take a denoising slot."""
        return any(e[2].deadline < math.inf for e in self._heap)

    @staticmethod
    def _deadline(req: GenerationRequest, now: float) -> float:
        return math.inf if req.slo_ms is None else now + req.slo_ms / 1e3

    def _notify_shed(self, reason: str, req: GenerationRequest,
                     now: float) -> None:
        if self.on_shed is not None:
            self.on_shed(reason, req, now)

    def submit(self, req: GenerationRequest, now: float = 0.0) -> bool:
        """Enqueue; returns False when the request was rejected.

        At the depth bound, ``'reject-newest'`` always returns False;
        ``'deadline-aware'`` evicts the queued entry with the earliest
        deadline when the arrival has strictly more slack (the arrival
        is admitted and ``evicted`` ticks up), and rejects the arrival
        otherwise."""
        deadline = self._deadline(req, now)
        if self.max_depth is not None and len(self._heap) >= self.max_depth:
            if self.shed_policy == 'deadline-aware' and self._heap:
                victim_i = min(range(len(self._heap)),
                               key=lambda i: (self._heap[i][2].deadline,
                                              -self._heap[i][1]))
                if self._heap[victim_i][2].deadline < deadline:
                    victim = self._heap.pop(victim_i)[2]
                    heapq.heapify(self._heap)
                    self.evicted += 1
                    self._notify_shed('evicted', victim.request, now)
                else:
                    self.rejected += 1
                    self._notify_shed('rejected', req, now)
                    return False
            else:
                self.rejected += 1
                self._notify_shed('rejected', req, now)
                return False
        self._seq += 1
        heapq.heappush(self._heap, (-req.priority, self._seq,
                                    Queued(req, now, deadline)))
        self.submitted += 1
        return True

    def pop(self) -> Optional[Queued]:
        """Highest-priority (then oldest) entry, or None when empty."""
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def peek(self) -> Optional[Queued]:
        """The entry ``pop`` would return, without removing it — the
        engine's phase-aligned admission looks ahead without committing
        (a held request keeps accruing queue delay until a refresh tick)."""
        if not self._heap:
            return None
        return self._heap[0][2]

    def expire(self, now: float,
               margin_s: Union[float,
                               Callable[[GenerationRequest], float]] = 0.0
               ) -> List[Queued]:
        """Remove and return every queued entry whose deadline has
        already passed (``deadline < now + margin_s``) — a dead request
        must never occupy a denoising slot.  ``margin_s`` lets the
        caller fold in an estimated service time so a request that
        *will* miss by the time it finishes is shed at admission too;
        pass a callable ``request -> seconds`` for per-request margins
        (the engine folds in ``steps x measured tick time``, which
        differs per request).  Counts into ``expired``."""
        margin = margin_s if callable(margin_s) else (lambda _r: margin_s)

        def dead_entry(e) -> bool:
            return e[2].deadline < now + margin(e[2].request)

        dead = [e for e in self._heap if dead_entry(e)]
        if not dead:
            return []
        self._heap = [e for e in self._heap if not dead_entry(e)]
        heapq.heapify(self._heap)
        self.expired += len(dead)
        out = [q for _, _, q in sorted(dead, key=lambda e: e[1])]
        for q in out:
            self._notify_shed('expired', q.request, now)
        return out

    def oldest_wait(self, now: float) -> float:
        """Age of the oldest queued request (0 when empty)."""
        if not self._heap:
            return 0.0
        return max(0.0, now - min(q.enqueue_time
                                  for _, _, q in self._heap))
