"""Trace exporters: JSONL structured event log and Chrome ``trace_event``.

Both exporters are strict-JSON by construction: ``sanitize`` rewrites
every non-finite float (NaN/inf — e.g. an unprobed PSNR mean) to
``null`` before serialization, and the writers pass ``allow_nan=False``
so a bare ``NaN`` token can never reach disk.

JSONL log — one event object per line, the flat ``TraceEvent.to_dict``
shape.  Grep-able, tail-able, trivially re-loadable (``read_jsonl``).

Chrome trace — the ``{"traceEvents": [...]}`` JSON the ``chrome://
tracing`` / Perfetto UI loads.  The serving run renders as one process
(pid 0) with one thread lane per engine slot plus two fixed lanes:

  * tid 0 ``scheduler`` — tick/step spans and engine-global events
    (warmup, AOT lowering, elastic resize, straggler flags);
  * tid 1..slots ``slot i (dev d)`` — per-request service spans and
    decode events, one lane per slot of the engine buffer;
  * tid 999 ``queue`` — submit/shed/expire instants.

Timestamps convert from serving-clock seconds to the microseconds the
format requires; counter events (occupancy) become ``ph='C'`` series
Perfetto draws as a stacked area.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, List, Union

from repro_torch.obs.tracer import TraceEvent, Tracer

#: Fixed Chrome-trace thread lanes (slots are 1..N between them).
SCHEDULER_TID = 0
QUEUE_TID = 999


def sanitize(obj: Any) -> Any:
    """Recursively replace non-finite floats with None (strict JSON)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    return obj


def _events(source: Union[Tracer, Iterable[TraceEvent]]) -> List[TraceEvent]:
    return list(source.events if isinstance(source, Tracer) else source)


# -- JSONL -------------------------------------------------------------------
def write_jsonl(source: Union[Tracer, Iterable[TraceEvent]],
                path: str) -> int:
    """Write one JSON object per event line; returns the event count."""
    events = _events(source)
    with open(path, 'w') as f:
        for e in events:
            f.write(json.dumps(sanitize(e.to_dict()), allow_nan=False,
                               sort_keys=True))
            f.write('\n')
    return len(events)


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL event log back into a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# -- Chrome trace ------------------------------------------------------------
def _tid(e: TraceEvent) -> int:
    if e.slot is not None:
        return 1 + e.slot
    if e.cat == 'queue':
        return QUEUE_TID
    return SCHEDULER_TID


def chrome_trace(source: Union[Tracer, Iterable[TraceEvent]],
                 pid: int = 0) -> Dict[str, Any]:
    """Render events as a Chrome ``trace_event`` document (dict)."""
    events = _events(source)
    rows: List[Dict[str, Any]] = [{
        'name': 'process_name', 'ph': 'M', 'pid': pid, 'tid': 0,
        'args': {'name': 'serving engine'}}]
    lanes: Dict[int, str] = {SCHEDULER_TID: 'scheduler'}
    for e in events:
        tid = _tid(e)
        if tid not in lanes:
            if tid == QUEUE_TID:
                lanes[tid] = 'queue'
            else:
                lanes[tid] = f'slot {tid - 1}' + (
                    f' (dev {e.device})' if e.device is not None else '')
        row: Dict[str, Any] = {
            'name': e.name, 'cat': e.cat, 'ph': e.ph,
            'ts': e.ts * 1e6, 'pid': pid, 'tid': tid}
        if e.ph == 'X':
            row['dur'] = e.dur * 1e6
        if e.ph == 'i':
            row['s'] = 't'          # instant scope: thread
        args = dict(e.args)
        for k in ('rid', 'device', 'tick'):
            v = getattr(e, k)
            if v is not None:
                args[k] = v
        if args:
            row['args'] = args
        rows.append(row)
    for tid, name in sorted(lanes.items()):
        rows.append({'name': 'thread_name', 'ph': 'M', 'pid': pid,
                     'tid': tid, 'args': {'name': name}})
    return sanitize({'traceEvents': rows,
                     'displayTimeUnit': 'ms'})


def write_chrome_trace(source: Union[Tracer, Iterable[TraceEvent]],
                       path: str, pid: int = 0) -> int:
    """Write the Chrome trace JSON; returns the trace-event row count."""
    doc = chrome_trace(source, pid=pid)
    with open(path, 'w') as f:
        json.dump(doc, f, allow_nan=False)
        f.write('\n')
    return len(doc['traceEvents'])
