"""Serving observability: per-request tracing, structured event logs,
Chrome-trace export, and Prometheus-style metrics exposition; a copy of
``repro/obs`` (standard library only).

Quickstart::

    from repro_torch.obs import Tracer, SnapshotReporter, write_chrome_trace
    tracer = Tracer()
    engine = ContinuousBatchingEngine(pipe, slots=4, tracer=tracer)
    engine.warmup()
    engine.replay(trace)
    write_chrome_trace(tracer, 'trace.json')      # chrome://tracing
    write_jsonl(tracer, 'events.jsonl')           # structured log
    print(render_exposition(engine.metrics))      # Prometheus text

Tracing is zero-cost when disabled: the engine default is the no-op
``NULL_TRACER`` (``enabled == False``) and every hot-path hook guards on
that flag, so an untraced engine builds no event objects at all.
"""
from repro_torch.obs.export import (chrome_trace, read_jsonl, sanitize,
                                    write_chrome_trace, write_jsonl)
from repro_torch.obs.prom import (NAMESPACE, SnapshotReporter,
                                  render_exposition)
from repro_torch.obs.tracer import (CATEGORIES, NULL_TRACER, NullTracer,
                                    TraceEvent, Tracer)

__all__ = [
    'Tracer', 'NullTracer', 'NULL_TRACER', 'TraceEvent', 'CATEGORIES',
    'chrome_trace', 'write_chrome_trace', 'write_jsonl', 'read_jsonl',
    'sanitize', 'render_exposition', 'SnapshotReporter', 'NAMESPACE',
]
