"""Serving metrics and the accuracy-vs-EPB frontier, port of
``repro/serving/metrics.py`` without the photonic accountant (it needs
the photonic workload model, which a later slice ports; until then every
result reports ``energy_j = epb_pj = 0``).

``ServingMetrics`` keeps the queue/latency ledger (p50/p95/p99 latency,
p50/p99 queue wait, requests/s, tick counters, SLO violations, sheds by
cause, peak queue depth, warmup and time-to-first-tick) plus one
``FrontierPoint`` per completed request and per-policy aggregates.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.serving.api import GenerationResult


@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    """One completed request on the accuracy-vs-energy frontier."""
    request_id: int
    precision: str
    epb_pj: float
    energy_j: float
    psnr_db: Optional[float]       # vs fp32 reference; None if not probed
    mse: Optional[float]


@dataclasses.dataclass
class MetricsSnapshot:
    submitted: int
    completed: int
    ticks: int
    unet_steps: int              # slot-steps of UNet work executed
    active_slots: int
    queued: int
    p50_latency_s: float
    p95_latency_s: float
    p99_latency_s: float
    requests_per_s: float
    total_energy_j: float
    slo_violations: int
    shed: int = 0                # total requests shed (all causes)
    shed_by_reason: Dict[str, int] = dataclasses.field(default_factory=dict)
    p50_queue_wait_s: float = 0.0
    p99_queue_wait_s: float = 0.0
    max_queue_depth: int = 0
    warmup_s: float = 0.0
    first_tick_s: float = 0.0
    frontier: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)


class ServingMetrics:
    def __init__(self):
        self.submitted = 0
        self.completed = 0
        self.ticks = 0
        self.unet_steps = 0
        self.total_energy_j = 0.0
        self.slo_violations = 0
        self.shed = 0
        self.shed_by_reason: Dict[str, int] = {}
        self.max_queue_depth = 0
        self.warmup_s: Optional[float] = None
        self.first_tick_s: Optional[float] = None
        self.frontier_points: List[FrontierPoint] = []
        self._latencies: List[float] = []       # kept sorted
        self._queue_waits: List[float] = []     # kept sorted
        self._first_submit: Optional[float] = None
        self._last_finish: Optional[float] = None
        self._by_policy: Dict[str, Dict[str, float]] = {}

    # -- recording ---------------------------------------------------------
    def record_submit(self, now: float):
        self.submitted += 1
        if self._first_submit is None or now < self._first_submit:
            self._first_submit = now

    def record_shed(self, reason: str = 'queue_full'):
        """One request shed: ``'queue_full'``, ``'deadline_evict'`` or
        ``'expired'``."""
        self.shed += 1
        self.shed_by_reason[reason] = self.shed_by_reason.get(reason, 0) + 1

    def observe_queue_depth(self, depth: int):
        if depth > self.max_queue_depth:
            self.max_queue_depth = depth

    def record_warmup(self, seconds: float):
        """Wall seconds spent in ``engine.warmup`` (cumulative)."""
        self.warmup_s = seconds if self.warmup_s is None \
            else self.warmup_s + seconds

    def record_first_tick(self, seconds: float):
        """Engine construction to completion of the first served tick."""
        if self.first_tick_s is None:
            self.first_tick_s = seconds

    def record_tick(self, active_slots: int):
        self.ticks += 1
        self.unet_steps += active_slots

    def record_complete(self, res: GenerationResult,
                        slo_ms: Optional[float] = None):
        self.completed += 1
        bisect.insort(self._latencies, res.latency_s)
        bisect.insort(self._queue_waits, res.queue_delay_s)
        self.total_energy_j += res.energy_j
        self._last_finish = res.finish_time if self._last_finish is None \
            else max(self._last_finish, res.finish_time)
        if slo_ms is not None and res.latency_s * 1e3 > slo_ms:
            self.slo_violations += 1
        self.frontier_points.append(FrontierPoint(
            request_id=res.request_id, precision=res.precision,
            epb_pj=res.epb_pj, energy_j=res.energy_j,
            psnr_db=res.quality_psnr_db, mse=res.quality_mse))
        d = self._by_policy.setdefault(res.precision, {
            'completed': 0.0, 'energy_j': 0.0, 'epb_sum': 0.0,
            'probed': 0.0, 'psnr_sum': 0.0, 'mse_sum': 0.0})
        d['completed'] += 1
        d['energy_j'] += res.energy_j
        d['epb_sum'] += res.epb_pj
        if res.quality_mse is not None:
            d['probed'] += 1
            d['mse_sum'] += res.quality_mse
            if res.quality_psnr_db is not None and \
                    math.isfinite(res.quality_psnr_db):
                d['psnr_sum'] += res.quality_psnr_db

    # -- reading -----------------------------------------------------------
    @staticmethod
    def _percentile(sorted_vals: List[float], p: float) -> float:
        """Nearest-rank percentile over a pre-sorted list (0.0 empty)."""
        if not sorted_vals:
            return 0.0
        idx = min(len(sorted_vals) - 1,
                  max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
        return sorted_vals[idx]

    def percentile_latency(self, p: float) -> float:
        return self._percentile(self._latencies, p)

    def percentile_queue_wait(self, p: float) -> float:
        return self._percentile(self._queue_waits, p)

    def requests_per_s(self) -> float:
        if (self.completed == 0 or self._first_submit is None
                or self._last_finish is None):
            return 0.0
        span = self._last_finish - self._first_submit
        return self.completed / max(span, 1e-9)

    def frontier(self) -> Dict[str, Dict[str, float]]:
        """Per-policy means over completed work: {precision: {completed,
        probed, mean_epb_pj, mean_energy_j, mean_psnr_db, mean_mse}};
        PSNR/MSE means run over probed requests only (NaN when none)."""
        out = {}
        for name, d in self._by_policy.items():
            n = max(d['completed'], 1.0)
            probed = d['probed']
            out[name] = {
                'completed': d['completed'],
                'probed': probed,
                'mean_epb_pj': d['epb_sum'] / n,
                'mean_energy_j': d['energy_j'] / n,
                'mean_psnr_db': (d['psnr_sum'] / probed) if probed
                else float('nan'),
                'mean_mse': (d['mse_sum'] / probed) if probed
                else float('nan'),
            }
        return out

    def snapshot(self, active_slots: int = 0,
                 queued: int = 0) -> MetricsSnapshot:
        return MetricsSnapshot(
            submitted=self.submitted, completed=self.completed,
            ticks=self.ticks, unet_steps=self.unet_steps,
            active_slots=active_slots, queued=queued,
            p50_latency_s=self.percentile_latency(50),
            p95_latency_s=self.percentile_latency(95),
            p99_latency_s=self.percentile_latency(99),
            requests_per_s=self.requests_per_s(),
            total_energy_j=self.total_energy_j,
            slo_violations=self.slo_violations,
            shed=self.shed,
            shed_by_reason=dict(self.shed_by_reason),
            p50_queue_wait_s=self.percentile_queue_wait(50),
            p99_queue_wait_s=self.percentile_queue_wait(99),
            max_queue_depth=self.max_queue_depth,
            warmup_s=self.warmup_s or 0.0,
            first_tick_s=self.first_tick_s or 0.0,
            frontier=self.frontier())
