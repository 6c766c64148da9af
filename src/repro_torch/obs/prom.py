"""Prometheus-style metrics exposition and the periodic snapshot reporter.

``render_exposition`` turns a ``ServingMetrics`` ledger into the
Prometheus text format (``# HELP`` / ``# TYPE`` headers, counters,
gauges, and summary quantiles with ``_sum``/``_count``) so a scrape
endpoint — or a file the deployment tails — always has the live
counters, not just the end-of-run ``summary()`` dict.  Shed causes and
per-precision frontier aggregates are exposed as labels
(``...shed_total{reason="expired"}``,
``...frontier_mean_epb_picojoules{precision="w8a8"}``).

``SnapshotReporter`` is the in-run view: hand it to the engine
(``engine.reporter``) and every tick it checks a wall-clock interval,
emitting one compact progress line every ``interval_s`` seconds —
completed/submitted, requests/s, latency percentiles, queue state —
through any callable (``print``, ``logger.info``, a file append).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

#: Default metric namespace (Prometheus metric-name prefix).
NAMESPACE = 'repro_serving'


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats compact."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Lines:
    def __init__(self):
        self.out: List[str] = []

    def metric(self, name: str, mtype: str, help_text: str):
        self.out.append(f'# HELP {name} {help_text}')
        self.out.append(f'# TYPE {name} {mtype}')

    def sample(self, name: str, value, labels: str = ''):
        self.out.append(f'{name}{labels} {_fmt(value)}')

    def render(self) -> str:
        return '\n'.join(self.out) + '\n'


def render_exposition(metrics, active_slots: int = 0, queued: int = 0,
                      namespace: str = NAMESPACE) -> str:
    """Prometheus text exposition of a ``ServingMetrics`` ledger."""
    s = metrics.snapshot(active_slots=active_slots, queued=queued)
    L = _Lines()
    n = namespace

    counters = [
        ('submitted_total', s.submitted, 'Requests admitted to the queue'),
        ('completed_total', s.completed, 'Requests completed'),
        ('slo_violations_total', s.slo_violations,
         'Completed requests that missed their SLO'),
        ('ticks_total', s.ticks, 'Engine scheduler ticks executed'),
        ('unet_steps_total', s.unet_steps,
         'Slot-steps of UNet work executed'),
        ('full_steps_total', s.full_steps,
         'Slot-steps run as full UNet passes'),
        ('cached_steps_total', s.cached_steps,
         'Slot-steps run as shallow DeepCache passes'),
        ('early_exits_total', s.early_exits,
         'Requests drained by x0-convergence early exit'),
        ('steps_saved_total', s.steps_saved,
         'Requested-minus-executed denoise steps'),
        ('overlapped_decodes_total', s.overlapped_decodes,
         'VAE decodes overlapped with the next denoise tick'),
        ('resizes_total', s.resizes, 'Elastic mesh resizes survived'),
    ]
    for name, val, help_text in counters:
        full = f'{n}_{name}'
        L.metric(full, 'counter', help_text)
        L.sample(full, val)

    full = f'{n}_shed_total'
    L.metric(full, 'counter', 'Requests shed, by cause')
    if s.shed_by_reason:
        for reason in sorted(s.shed_by_reason):
            L.sample(full, s.shed_by_reason[reason],
                     labels=f'{{reason="{reason}"}}')
    else:
        L.sample(full, 0)

    full = f'{n}_energy_joules_total'
    L.metric(full, 'counter',
             'Simulated photonic energy attributed to completed requests')
    L.sample(full, s.total_energy_j)

    gauges = [
        ('active_slots', s.active_slots, 'Occupied engine slots'),
        ('queued', s.queued, 'Requests waiting in the admission queue'),
        ('queue_depth_peak', s.max_queue_depth,
         'Peak observed admission-queue depth'),
        ('devices', s.devices, 'Slot-shard device count'),
        ('requests_per_second', s.requests_per_s,
         'Completed-request throughput over the serving span'),
        ('cache_hit_rate', s.cache_hit_rate,
         'Fraction of slot-steps served by the shallow DeepCache pass'),
        ('warmup_seconds', s.warmup_s,
         'Wall seconds spent compiling in engine warmup'),
        ('first_tick_seconds', s.first_tick_s,
         'Engine construction to first served tick'),
    ]
    for name, val, help_text in gauges:
        full = f'{n}_{name}'
        L.metric(full, 'gauge', help_text)
        L.sample(full, val)

    for base, quantiles, sum_s, help_text in (
            ('latency_seconds',
             ((0.5, s.p50_latency_s), (0.95, s.p95_latency_s),
              (0.99, s.p99_latency_s)),
             metrics.latency_sum_s,
             'End-to-end request latency (submit to finish)'),
            ('queue_wait_seconds',
             ((0.5, s.p50_queue_wait_s), (0.99, s.p99_queue_wait_s)),
             metrics.queue_wait_sum_s,
             'Queue wait (submit to slot start)')):
        full = f'{n}_{base}'
        L.metric(full, 'summary', help_text)
        for q, v in quantiles:
            L.sample(full, v, labels=f'{{quantile="{q}"}}')
        L.sample(f'{full}_sum', sum_s)
        L.sample(f'{full}_count', s.completed)

    frontier = s.frontier
    if frontier:
        specs = (('frontier_completed', 'completed',
                  'Completed requests per precision policy'),
                 ('frontier_mean_epb_picojoules', 'mean_epb_pj',
                  'Mean energy-per-bit per precision policy'),
                 ('frontier_mean_energy_joules', 'mean_energy_j',
                  'Mean per-request energy per precision policy'))
        for name, key, help_text in specs:
            full = f'{n}_{name}'
            L.metric(full, 'gauge', help_text)
            for pol in sorted(frontier):
                L.sample(full, frontier[pol][key],
                         labels=f'{{precision="{pol}"}}')
    return L.render()


class SnapshotReporter:
    """Periodic in-run metrics line: call ``maybe_report(engine)`` (the
    engine does, once per tick, when installed as ``engine.reporter``)
    and a compact snapshot is emitted every ``interval_s`` wall seconds.
    The first call arms the interval without reporting, so an idle
    engine never logs at t=0."""

    def __init__(self, interval_s: float = 5.0,
                 emit: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if interval_s <= 0:
            raise ValueError('interval_s must be > 0')
        self.interval_s = interval_s
        self._emit = emit if emit is not None \
            else (lambda line: print(line, flush=True))
        self._clock = clock
        self._last: Optional[float] = None
        self.reports = 0

    def maybe_report(self, engine=None, metrics=None, active_slots: int = 0,
                     queued: int = 0, force: bool = False) -> Optional[str]:
        t = self._clock()
        if self._last is None:
            self._last = t
            if not force:
                return None
        if not force and t - self._last < self.interval_s:
            return None
        self._last = t
        if engine is not None:
            metrics = engine.metrics
            active_slots = engine.active_count
            queued = len(engine.queue)
        s = metrics.snapshot(active_slots=active_slots, queued=queued)
        line = (f'completed={s.completed}/{s.submitted} '
                f'rps={s.requests_per_s:.2f} '
                f'p50={s.p50_latency_s * 1e3:.0f}ms '
                f'p95={s.p95_latency_s * 1e3:.0f}ms '
                f'shed={s.shed} active={s.active_slots} '
                f'queued={s.queued} ticks={s.ticks}')
        self._emit(line)
        self.reports += 1
        return line
