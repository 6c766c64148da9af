"""Span/event tracer for the serving stack.

One ``Tracer`` records a serving run as a flat list of ``TraceEvent``
rows — instants (a request was submitted, a shed happened, a straggler
was flagged), complete spans (a step dispatch, a whole tick, warmup, a
request's submit-to-finish lifetime) and counters (occupancy per tick).
Timestamps ride the *serving clock*: ``now()`` is monotonic seconds
since the tracer's origin (``time.perf_counter`` based), and
``set_origin`` lets the engine pin that origin to its replay wall-clock
zero so trace timestamps and ``GenerationResult`` timing fields agree
exactly.  Events recorded with an explicit ``ts`` (e.g. a request span
stamped from the result's own submit/finish times) reconcile with
``ServingMetrics`` by construction.

Tracing is ZERO-COST when disabled: the default engine tracer is the
module singleton ``NULL_TRACER`` whose ``enabled`` flag is False — hot
paths guard on that flag and never build event objects, and every
recording method is a no-op.  An enabled tracer appends one small
dataclass per event; exporters (``repro_torch.obs.export``) turn the
list into a JSONL structured log or a Chrome/Perfetto ``trace_event`` timeline.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional

#: Event categories used by the serving instrumentation.  Free-form —
#: exporters pass them through — but the engine sticks to this set.
CATEGORIES = ('queue', 'request', 'tick', 'decode', 'engine')


@dataclasses.dataclass
class TraceEvent:
    """One trace row.  ``ph`` follows the Chrome trace_event phases the
    exporter maps onto: ``'i'`` instant, ``'X'`` complete (has ``dur``),
    ``'C'`` counter (values live in ``args``)."""
    name: str
    cat: str
    ph: str
    ts: float                       # serving-clock seconds
    dur: float = 0.0                # seconds ('X' events only)
    rid: Optional[int] = None       # request id, when request-scoped
    slot: Optional[int] = None      # engine slot index, when slot-scoped
    device: Optional[int] = None    # mesh device index, when known
    tick: Optional[int] = None      # engine tick index, when tick-scoped
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        """Flat dict for the JSONL log (None-valued ids dropped)."""
        d = {'name': self.name, 'cat': self.cat, 'ph': self.ph,
             'ts': self.ts}
        if self.ph == 'X':
            d['dur'] = self.dur
        for k in ('rid', 'slot', 'device', 'tick'):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.args:
            d['args'] = self.args
        return d


class Tracer:
    """Collects ``TraceEvent`` rows on a monotonic serving clock."""

    enabled = True

    def __init__(self):
        self._t0 = time.perf_counter()
        self.events: List[TraceEvent] = []

    # -- clock --------------------------------------------------------------
    def now(self) -> float:
        """Seconds since the trace origin (monotonic)."""
        return time.perf_counter() - self._t0

    def set_origin(self, perf_counter_t0: float) -> None:
        """Pin the trace origin to a ``time.perf_counter()`` reading —
        the engine passes its replay wall-clock zero so trace timestamps
        live on the same serving clock as request timing fields."""
        self._t0 = perf_counter_t0

    # -- recording ----------------------------------------------------------
    def instant(self, name: str, cat: str = 'engine',
                ts: Optional[float] = None, rid: Optional[int] = None,
                slot: Optional[int] = None, device: Optional[int] = None,
                tick: Optional[int] = None, **args) -> TraceEvent:
        e = TraceEvent(name=name, cat=cat, ph='i',
                       ts=self.now() if ts is None else ts,
                       rid=rid, slot=slot, device=device, tick=tick,
                       args=args)
        self.events.append(e)
        return e

    def complete(self, name: str, t0: float, t1: float,
                 cat: str = 'engine', rid: Optional[int] = None,
                 slot: Optional[int] = None, device: Optional[int] = None,
                 tick: Optional[int] = None, **args) -> TraceEvent:
        """A finished span ``[t0, t1]`` on the serving clock."""
        e = TraceEvent(name=name, cat=cat, ph='X', ts=t0,
                       dur=max(0.0, t1 - t0), rid=rid, slot=slot,
                       device=device, tick=tick, args=args)
        self.events.append(e)
        return e

    def counter(self, name: str, cat: str = 'engine',
                ts: Optional[float] = None, tick: Optional[int] = None,
                **values) -> TraceEvent:
        """A counter sample (numeric series, e.g. occupancy per tick)."""
        e = TraceEvent(name=name, cat=cat, ph='C',
                       ts=self.now() if ts is None else ts,
                       tick=tick, args=values)
        self.events.append(e)
        return e

    @contextlib.contextmanager
    def region(self, name: str, cat: str = 'engine',
               **args) -> Iterator[None]:
        """Span context manager on the tracer clock."""
        t0 = self.now()
        try:
            yield
        finally:
            self.complete(name, t0, self.now(), cat=cat, **args)

    # -- reading ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def select(self, name: Optional[str] = None, cat: Optional[str] = None,
               ph: Optional[str] = None) -> List[TraceEvent]:
        """Events filtered by name/category/phase (None = any)."""
        return [e for e in self.events
                if (name is None or e.name == name)
                and (cat is None or e.cat == cat)
                and (ph is None or e.ph == ph)]

    def spans(self, name: Optional[str] = None,
              cat: Optional[str] = None) -> List[TraceEvent]:
        """Complete ('X') events, optionally filtered."""
        return self.select(name=name, cat=cat, ph='X')


class NullTracer(Tracer):
    """No-op tracer: the zero-cost default.  ``enabled`` is False, so
    instrumented hot paths skip event construction entirely; the
    recording methods are inert for call sites that don't guard."""

    enabled = False

    def __init__(self):
        super().__init__()

    def instant(self, *a, **k) -> None:          # type: ignore[override]
        return None

    def complete(self, *a, **k) -> None:         # type: ignore[override]
        return None

    def counter(self, *a, **k) -> None:          # type: ignore[override]
        return None

    @contextlib.contextmanager
    def region(self, *a, **k) -> Iterator[None]:
        yield


#: Shared no-op singleton — the engine's default ``tracer``.
NULL_TRACER = NullTracer()
