"""Serving metrics, per-request photonic energy and the accuracy-vs-EPB
frontier, port of ``repro/serving/metrics.py``.

``PhotonicAccountant`` scales the UNet's per-step operation counts
(``core/photonic/workload.py``) by the UNet evaluations a request
consumed (its DDIM steps, doubled under classifier-free guidance; a
DeepCache skip pass billed at ``shallow_fraction`` of a full one) and
runs them through ``simulator.simulate``, so every completed request
reports the Joules DiffLight would have spent on it and the energy per
bit.  ``w8a8`` and ``w8a8+noise`` requests ride the analog MR banks (the
simulated numbers); ``fp32`` requests are billed the paper's Fig. 10 GPU
digital baseline (EPB at 94.18x DiffLight's, 32-bit operands).

``ServingMetrics`` keeps the queue/latency ledger (p50/p95/p99 latency,
p50/p99 queue wait and their sums, requests/s, tick counters, SLO
violations, sheds by cause, peak queue depth, warmup, time-to-first-tick,
decodes overlapped with the next tick, elastic resizes and the slot-shard
count), the DeepCache
and early-exit counters (full and cached slot-steps, cache hit rate,
mixed ticks, early exits, steps saved) and the frontier: one
``FrontierPoint`` per completed request and per-policy aggregates.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.api import GenerationResult

#: Fig. 10 anchor: DiffLight's average EPB improvement over the GPU
#: (RTX 4070) digital baseline, what an fp32 request is billed per bit
FP32_DIGITAL_EPB_X = 94.18
#: fp32 operands carry 4x the bits of the 8-bit analog datapath
FP32_BITS_X = 4.0


class PhotonicAccountant:
    """Per-request energy: workload counts x simulate(), per precision."""

    def __init__(self, unet_cfg, arch_cfg=None, ctx_len: Optional[int] = 77):
        from repro_torch.core.photonic.arch import PAPER_OPTIMUM
        from repro_torch.core.photonic.workload import unet_workload
        self.arch_cfg = arch_cfg or PAPER_OPTIMUM
        self.unet_cfg = unet_cfg
        self._per_step = unet_workload(
            unet_cfg, ctx_len=ctx_len if unet_cfg.context_dim else None)
        self._cache: Dict[float, object] = {}
        self._shallow_frac: Optional[float] = None

    @property
    def shallow_fraction(self) -> float:
        """MAC fraction of a DeepCache skip pass vs a full UNet pass: the
        workload transform a skip tick is billed through."""
        if self._shallow_frac is None:
            from repro_torch.diffusion.deepcache import \
                shallow_workload_fraction
            self._shallow_frac = shallow_workload_fraction(self.unet_cfg)
        return self._shallow_frac

    def _report_factor(self, factor: float):
        from repro_torch.core.photonic.simulator import simulate
        key = round(float(factor), 9)
        if key not in self._cache:
            self._cache[key] = simulate(
                self._per_step.scale(factor), self.arch_cfg,
                name=f'{self._per_step.name}/x{key:g}')
        return self._cache[key]

    def report(self, steps: int, guided: bool = False):
        """SimReport for one request: ``steps`` UNet evaluations (2x when
        classifier-free guidance runs the conditional and unconditional
        pass per step)."""
        return self._report_factor(steps * (2 if guided else 1))

    def report_evals(self, full_evals: int, cached_evals: int = 0,
                     guided: bool = False):
        """SimReport for a DeepCache-phased request: ``full_evals`` full
        UNet passes plus ``cached_evals`` skip passes, each billed at
        ``shallow_fraction`` of a full pass, doubled under guidance."""
        mult = 2 if guided else 1
        factor = mult * (full_evals + cached_evals * self.shallow_fraction)
        return self._report_factor(factor)

    def energy(self, steps: int, guided: bool = False,
               precision: str = 'w8a8'):
        """(energy_j, epb_pj) for one request at the given precision:
        quantized precisions take the DiffLight simulation unchanged (noise
        injection is free: the analog datapath is the same); ``fp32``
        scales EPB by the GPU digital anchor and energy by the anchor x 4
        (32-bit vs 8-bit operands)."""
        return self._price(self.report(steps, guided), precision)

    def energy_evals(self, full_evals: int, cached_evals: int = 0,
                     guided: bool = False, precision: str = 'w8a8'):
        """(energy_j, epb_pj) for a request that consumed ``full_evals``
        full ticks and ``cached_evals`` DeepCache skip ticks."""
        return self._price(self.report_evals(full_evals, cached_evals,
                                             guided), precision)

    @staticmethod
    def _price(rep, precision: str):
        if precision == 'fp32':
            return (rep.energy_j * FP32_DIGITAL_EPB_X * FP32_BITS_X,
                    rep.epb_pj * FP32_DIGITAL_EPB_X)
        return rep.energy_j, rep.epb_pj


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
    # DeepCache / early-exit scheduler counters
    full_steps: int = 0          # slot-steps run as full UNet passes
    cached_steps: int = 0        # slot-steps run as shallow (skip) passes
    cache_hit_rate: float = 0.0  # cached_steps / unet_steps
    mixed_ticks: int = 0         # ticks paying both a full and a skip pass
    early_exits: int = 0         # requests drained by x0 convergence
    steps_saved: int = 0         # total requested-minus-executed steps
    steps_saved_hist: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    resizes: int = 0             # elastic mesh resizes survived
    devices: int = 1             # slot-shard count after the last resize
    overlapped_decodes: int = 0  # drains whose VAE decode overlapped the
    #                              next denoise tick
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
        self.full_steps = 0
        self.cached_steps = 0
        self.mixed_ticks = 0
        self.early_exits = 0
        self.steps_saved = 0
        self.steps_saved_hist: Dict[int, int] = {}
        self.resizes: List[Tuple[int, int]] = []    # (old, new) devices
        self.devices = 1
        self.overlapped_decodes = 0
        self.frontier_points: List[FrontierPoint] = []
        self.latency_sum_s = 0.0      # summary _sum for the exposition
        self.queue_wait_sum_s = 0.0
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

    def record_resize(self, old_devices: int, new_devices: int):
        """One elastic mesh resize survived (devices dropped or
        rejoined)."""
        self.resizes.append((old_devices, new_devices))
        self.devices = new_devices

    def record_overlapped_decode(self, n: int = 1):
        """Drains whose VAE decode ran behind the next denoise tick."""
        self.overlapped_decodes += n

    def record_tick(self, active_slots: int,
                    full_slots: Optional[int] = None,
                    cached_slots: int = 0):
        """``full_slots`` / ``cached_slots`` split the tick's slot-steps
        into full-UNet and shallow DeepCache passes (default: all full);
        a tick paying both is a ``mixed_tick``."""
        self.ticks += 1
        self.unet_steps += active_slots
        if full_slots is None:
            full_slots = active_slots
        self.full_steps += full_slots
        self.cached_steps += cached_slots
        if full_slots > 0 and cached_slots > 0:
            self.mixed_ticks += 1

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of executed slot-steps served by the shallow pass."""
        return self.cached_steps / max(self.unet_steps, 1)

    def record_complete(self, res: GenerationResult,
                        slo_ms: Optional[float] = None):
        self.completed += 1
        bisect.insort(self._latencies, res.latency_s)
        bisect.insort(self._queue_waits, res.queue_delay_s)
        self.latency_sum_s += res.latency_s
        self.queue_wait_sum_s += res.queue_delay_s
        self.total_energy_j += res.energy_j
        self._last_finish = res.finish_time if self._last_finish is None \
            else max(self._last_finish, res.finish_time)
        if slo_ms is not None and res.latency_s * 1e3 > slo_ms:
            self.slo_violations += 1
        executed = res.steps if res.steps_executed is None \
            else res.steps_executed
        saved = res.steps - executed
        self.steps_saved += saved
        self.steps_saved_hist[saved] = self.steps_saved_hist.get(saved, 0) + 1
        if res.early_exit:
            self.early_exits += 1
        self.frontier_points.append(FrontierPoint(
            request_id=res.request_id, precision=res.precision,
            epb_pj=res.epb_pj, energy_j=res.energy_j,
            psnr_db=res.quality_psnr_db, mse=res.quality_mse))
        d = self._by_policy.setdefault(res.precision, {
            'completed': 0.0, 'energy_j': 0.0, 'epb_sum': 0.0,
            'probed': 0.0, 'psnr_sum': 0.0, 'mse_sum': 0.0,
            'steps_sum': 0.0, 'executed_sum': 0.0, 'saved_sum': 0.0,
            'full_evals': 0.0, 'cached_evals': 0.0, 'early_exits': 0.0})
        d['completed'] += 1
        d['energy_j'] += res.energy_j
        d['epb_sum'] += res.epb_pj
        d['steps_sum'] += res.steps
        d['executed_sum'] += executed
        d['saved_sum'] += saved
        d['full_evals'] += res.full_evals
        d['cached_evals'] += res.cached_evals
        d['early_exits'] += bool(res.early_exit)
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
        probed, mean_epb_pj, mean_energy_j, mean_psnr_db, mean_mse,
        mean_steps_requested, mean_steps_executed, mean_steps_saved,
        cache_hit_rate, early_exits}}; PSNR/MSE means run over probed
        requests only (NaN when none); ``cache_hit_rate`` is the share of
        this policy's evaluations served by the DeepCache skip pass."""
        out = {}
        for name, d in self._by_policy.items():
            n = max(d['completed'], 1.0)
            probed = d['probed']
            evals = max(d['full_evals'] + d['cached_evals'], 1.0)
            out[name] = {
                'completed': d['completed'],
                'probed': probed,
                'mean_epb_pj': d['epb_sum'] / n,
                'mean_energy_j': d['energy_j'] / n,
                'mean_psnr_db': (d['psnr_sum'] / probed) if probed
                else float('nan'),
                'mean_mse': (d['mse_sum'] / probed) if probed
                else float('nan'),
                'mean_steps_requested': d['steps_sum'] / n,
                'mean_steps_executed': d['executed_sum'] / n,
                'mean_steps_saved': d['saved_sum'] / n,
                'cache_hit_rate': d['cached_evals'] / evals,
                'early_exits': d['early_exits'],
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
            full_steps=self.full_steps,
            cached_steps=self.cached_steps,
            cache_hit_rate=self.cache_hit_rate,
            mixed_ticks=self.mixed_ticks,
            early_exits=self.early_exits,
            steps_saved=self.steps_saved,
            steps_saved_hist=dict(self.steps_saved_hist),
            resizes=len(self.resizes),
            devices=self.devices,
            overlapped_decodes=self.overlapped_decodes,
            frontier=self.frontier())

    def summary(self) -> Dict[str, float]:
        """The end-of-run report, key for key as the reference's: one
        ``shed_<reason>`` key per shed cause beside ``deadline_sheds``
        (the expired and evicted sheds together)."""
        s = self.snapshot()
        out = {
            'completed': float(s.completed),
            'requests_per_s': s.requests_per_s,
            'p50_latency_ms': s.p50_latency_s * 1e3,
            'p95_latency_ms': s.p95_latency_s * 1e3,
            'p99_latency_ms': s.p99_latency_s * 1e3,
            'total_energy_mj': s.total_energy_j * 1e3,
            'energy_per_request_mj': (s.total_energy_j * 1e3 /
                                      max(s.completed, 1)),
            'slo_violations': float(s.slo_violations),
            'shed': float(s.shed),
            'deadline_sheds': float(
                s.shed_by_reason.get('deadline_evict', 0)
                + s.shed_by_reason.get('expired', 0)),
            'p50_queue_wait_ms': s.p50_queue_wait_s * 1e3,
            'p99_queue_wait_ms': s.p99_queue_wait_s * 1e3,
            'max_queue_depth': float(s.max_queue_depth),
            'warmup_s': s.warmup_s,
            'first_tick_s': s.first_tick_s,
            'cache_hit_rate': s.cache_hit_rate,
            'early_exits': float(s.early_exits),
            'steps_saved': float(s.steps_saved),
            'resizes': float(s.resizes),
            'devices': float(s.devices),
            'overlapped_decodes': float(s.overlapped_decodes),
        }
        for reason, count in sorted(s.shed_by_reason.items()):
            out[f'shed_{reason}'] = float(count)
        return out
